"""A domain-skewed protein database at a published length distribution.

Each protein's length is drawn from a log-normal (`lengths`: median,
sigma, least length); the protein is then filled to that length with
random linkers (`linkers`: lengths drawn uniformly, cut from one random
residue pool) each followed by a library domain (`domains`: one domain a
`proteins_per_domain` proteins, of uniform random lengths, drawn with
popularity ~ 1 / (rank + `popularity_offset`)), the last piece cut at the
length.  So k-mer postings have the heavy-tailed family structure of
real proteins, and the records have their widths.  The domain library and
its popularity are those of the program's bench/data.py
write_skewed_fasta; the lengths are the configuration's.
"""

from __future__ import annotations

import numpy as np

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
POOL = 1 << 22


def lengths(rng, n: int, p: dict) -> np.ndarray:
    raw = np.exp(rng.normal(np.log(float(p["median_aa"])), float(p["sigma"]),
                            size=n))
    return np.maximum(np.rint(raw), int(p["min_aa"])).astype(np.int64)


def write(fasta: str, config: dict) -> None:
    n = int(config["proteins"])
    dom_p, link_p = config["domains"], config["linkers"]
    rng = np.random.default_rng(int(config["db_seed"]))
    D = max(64, n // int(dom_p["proteins_per_domain"]))
    dom_len = rng.integers(int(dom_p["min_aa"]), int(dom_p["max_aa"]) + 1,
                           size=D)
    flat = AA[rng.integers(0, 20, size=int(dom_len.sum()))].tobytes()
    ends = np.cumsum(dom_len).tolist()
    doms = [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]
    pop = 1.0 / (np.arange(D) + float(dom_p["popularity_offset"]))
    pop /= pop.sum()
    want = lengths(rng, n, config["lengths"])
    pool = AA[rng.integers(0, 20, size=POOL)].tobytes()
    lo, hi = int(link_p["min_aa"]), int(link_p["max_aa"])
    # enough (linker, domain) pairs for every protein at the shortest
    # pair, drawn in one go
    n_pairs = int(want.sum()) // (lo + int(dom_p["min_aa"])) + n
    link_len = rng.integers(lo, hi + 1, size=n_pairs).tolist()
    link_off = rng.integers(0, POOL - hi, size=n_pairs).tolist()
    dom_idx = rng.choice(D, size=n_pairs, p=pop).tolist()
    c = 0
    with open(fasta, "wb") as f:
        for i, L in enumerate(want.tolist()):
            parts, got = [], 0
            while got < L:
                o, l, d = link_off[c], link_len[c], doms[dom_idx[c]]
                c += 1
                parts += (pool[o:o + l], d)
                got += l + len(d)
            f.write(b">S%07d skewed\n%s\n" % (i, b"".join(parts)[:L]))
