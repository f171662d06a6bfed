"""The TSV rows a kaamer server answers a query with (search.go:497-607),
worked out from the reference's own postings.

- Ranking: count descending, then protein (its place in the FASTA).
- FilterResults (search.go:189-220): walk the ranking and stop at the
  first hit whose count over the query's k-mers is below MinKRatio or
  whose count is below MinKMatch; keep at most MaxResults.
- A translated ORF is searched only when its best count reaches
  MinKMatch (search_nucleotide.go:116), and its start is refined first
  (orf.py).
- The row: query id, subject id, the k-match identity as a float32
  percentage with two decimals, the query's k-mers, the count, "N/A" for
  the gap column, the query's start and end, "1" and "N/A".

`precision="bfloat16"` is the control: the count, which the configuration
states as accumulated in float32, and the float32 percentage are both
rounded to bfloat16 at each step.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import orf as orfs
from .kmers import K, seq_codes


def bf16(x) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even)."""
    a = np.atleast_1d(np.asarray(x, np.float32)).copy()
    u = a.view(np.uint32)
    u += np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    u &= np.uint32(0xFFFF0000)
    return a


def pct(km: int, size: int, precision: str) -> str:
    if precision == "bfloat16":
        v = bf16(bf16(bf16(km)[0] / bf16(size)[0])[0] * bf16(100.0)[0])[0]
    else:
        v = np.float32(km) / np.float32(size) * np.float32(100.0)
    return f"{float(v):.2f}"


def _counted(rows: np.ndarray, counts: np.ndarray, precision: str):
    if precision != "bfloat16" or counts.size == 0:
        return rows, counts
    c = bf16(counts.astype(np.float32)).astype(np.int64)
    order = np.lexsort((rows, -c))
    return rows[order], c[order]


def _kept(counts, size: int, opts: Dict) -> int:
    good = 0
    for km in counts.tolist():
        if (km / size if size else 0.0) < opts["min_kratio"] \
                or km < opts["min_kmatch"]:
            break
        good += 1
    return min(good, opts["max_results"])


def _format(qname, ids, rows, counts, size, start, end, precision):
    return [f"{qname}\t{ids[int(r)]}\t{pct(int(c), size, precision)}\t{size}"
            f"\t{int(c)}\tN/A\t{start}\t{end}\t1\tN/A\n"
            for r, c in zip(rows.tolist(), counts.tolist())]


def protein_rows(postings, ids, name: str, seq: str, opts: Dict,
                 precision: str = "float32") -> List[str]:
    size = len(seq) - K + 1
    if size < K:  # kaamer skips a query this short
        return []
    rows, counts, _ = postings.ranked_hits(seq_codes(seq, size))
    rows, counts = _counted(rows, counts, precision)
    n = _kept(counts, size, opts)
    return _format(name.split(" ", 1)[0], ids, rows[:n], counts[:n], size,
                   1, len(seq), precision)


def translated_rows(postings, ids, name: str, dna: str, opts: Dict,
                    precision: str = "float32") -> List[str]:
    qname = name.split(" ", 1)[0]
    out: List[str] = []
    for o in orfs.orfs(dna):
        size = orfs.n_kmers(o.seq)
        if size < 1:
            continue
        rows, counts, sl = postings.ranked_hits(seq_codes(o.seq, size))
        rows, counts = _counted(rows, counts, precision)
        if counts.size == 0 or int(counts[0]) < opts["min_kmatch"]:
            continue
        start = o.start
        if len(o.alts) > 1:
            ties = rows[counts == counts[0]]
            first = 999999999
            exit_flag = False
            for j, r in enumerate(ties.tolist()):
                if exit_flag:
                    # the reference's shared exit flag (dna.go:225-237):
                    # once a best hit has matched, later ones are read at
                    # position 0 only
                    if postings.contains(sl, 0, ties[j:]).any():
                        first = 0
                    break
                bm = postings.bitmap(sl, size, r)
                if bm.any():
                    first = min(first, int(bm.argmax()))
                    exit_flag = True
            best = orfs.best_start(o.alts, first)
            if best != o.alts[0]:
                start = start + 3 * best if o.plus else start - 3 * best
                size = orfs.n_kmers(o.seq[best:])
        n = _kept(counts, size, opts)
        out += _format(qname, ids, rows[:n], counts[:n], size, start, o.end,
                       precision)
    return out
