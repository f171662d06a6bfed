"""Reads: `count` a request, a `from_db_share` of them `fragment_aa`
residues of a database protein at least that long, reverse-translated and
flanked by `flank` (make_reads_fastq in the program's bench/data.py), with
each base substituted at `substitution_rate`; the rest random DNA of the
same length.  FASTQ."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.generate import BASES, CODON_LUT


def make(rng, db, p: Dict) -> List[str]:
    n = int(p["count"])
    frag = int(p["fragment_aa"])
    flank = np.frombuffer(p["flank"].encode(), np.uint8)
    length = 2 * flank.shape[0] + 3 * frag
    from_db = rng.permutation(n) < round(n * float(p["from_db_share"]))
    src = np.flatnonzero(from_db)
    eligible = np.flatnonzero(db.lengths >= frag)
    rows = eligible[rng.integers(0, eligible.shape[0], size=src.shape[0])]
    lens = db.lengths[rows]
    starts = rng.integers(0, lens - frag + 1)
    prot = db.residues[(db.offsets[rows] + starts)[:, None] + np.arange(frag)]
    dna = BASES[rng.integers(0, 4, size=(n, length))]
    dna[src] = np.concatenate(
        [np.broadcast_to(flank, (src.shape[0], flank.shape[0])),
         CODON_LUT[prot].reshape(src.shape[0], 3 * frag),
         np.broadcast_to(flank, (src.shape[0], flank.shape[0]))], axis=1)
    sub = rng.random((src.shape[0], length)) < float(p["substitution_rate"])
    base = np.searchsorted(BASES, dna[src])
    shifted = BASES[(base + rng.integers(1, 4, size=base.shape)) % 4]
    dna[src] = np.where(sub, shifted, dna[src])
    return [r.tobytes().decode() for r in dna]


def text(names: List[str], seqs: List[str]) -> str:
    return "".join(f"@{a}\n{s}\n+\n{'I' * len(s)}\n"
                   for a, s in zip(names, seqs))
