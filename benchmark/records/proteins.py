"""Proteins: `count` a request, a `from_db_share` of them whole database
proteins at their own lengths with 0 to `mutations_max` point mutations
(the rule of make_queries in the program's bench/data.py, uncut), the rest
random orphans whose lengths are those of random database proteins.
FASTA."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.generate import AA


def _mutated(rng, db, rows, mutations_max: int) -> List[np.ndarray]:
    out = []
    for r in rows.tolist():
        s = np.array(db.protein(r))
        m = int(rng.integers(0, mutations_max + 1))
        pos = rng.integers(0, s.shape[0], size=m)
        s[pos] = AA[rng.integers(0, 20, size=m)]
        out.append(s)
    return out


def make(rng, db, p: Dict) -> List[str]:
    n = int(p["count"])
    from_db = rng.permutation(n) < round(n * float(p["from_db_share"]))
    rows = rng.integers(0, db.n_proteins, size=n)
    seqs = [None] * n
    src = np.flatnonzero(from_db)
    for i, s in zip(src.tolist(),
                    _mutated(rng, db, rows[src], int(p["mutations_max"]))):
        seqs[i] = s.tobytes().decode()
    orphans = np.flatnonzero(~from_db)
    lens = db.lengths[rows[orphans]]
    flat = AA[rng.integers(0, 20, size=int(lens.sum()))].tobytes().decode()
    ends = np.cumsum(lens).tolist()
    for i, a, b in zip(orphans.tolist(), [0] + ends[:-1], ends):
        seqs[i] = flat[a:b]
    return seqs


def text(names: List[str], seqs: List[str]) -> str:
    return "".join(f">{a}\n{s}\n" for a, s in zip(names, seqs))
