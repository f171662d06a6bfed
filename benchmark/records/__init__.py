"""Record kinds of a traffic mix, one a file, named by the mix's
`records.kind`; each has `make(rng, db, params)` (the records' sequences)
and `text(names, seqs)` (the uploaded file)."""
