"""The plain reference the benchmark judges the served bodies by.

NumPy and the standard library only: it imports nothing of the program
(`kaamer_tpu_torch`), of the JAX package or of JAX, and reads nothing the
program made.  It builds its own k-mer postings from a configuration's
FASTA (`kmers.py`), scans reads in six frames by the bacterial genetic code
(`orf.py`) and writes the TSV rows a kaamer server answers with
(`rows.py`).
"""
