"""Client loops of a traffic mix, one a file, named by the mix's
`loop.kind`; each has `run(send, requests, deadline)`."""
