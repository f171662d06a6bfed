"""Database generators, one a file, named by a configuration's
`generator`; each has `write(fasta, config)`."""
