"""Batch alignment for -aln on torch (kaamer_tpu/ops/swalign.py).

The routing rule is the JAX package's: a batch of at least 4 pairs whose
sequences are all at most 2048 residues runs on the device
(ops/swalign_cuda.py); any other batch runs the host DP (_smith_waterman)
and is counted in HOST_DP_PAIRS.  Nothing else falls back: a device
failure raises.

The host half is the JAX package's, copied unchanged: the wavefront Gotoh
DP with its traceback (_dp_matrices, _smith_waterman) and the
reference-formula result fields (result_from_ops, align.go:46-161):
identity/similarity/mismatch accounting (align.go:82-101), raw-score gap
adjustment (116-132), bit score S' = (lambda*S - ln K)/ln 2 (136) and
E-value m*n/2^S' with n = database AA count (141).  A run of g gap
columns costs gapOpen + (g-1)*gapExtend.  Selenocysteine 'U'/'u' is
replaced by '*' before alignment (align.go:38, 53-55).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..records import KStats
from ..search.results import AlignmentResult
from .matrices import (LETTER_INDEX, MatrixScores, NoMatrixError,
                       get_matrix_scores)
from .swalign_cuda import MAX_LEN, sw_batch_dispatch, sw_batch_resolve

NEG_INF = np.int32(-(10**8))

# pairs aligned by the host DP under the routing rule (< 4 pairs or a
# sequence longer than MAX_LEN)
HOST_DP_PAIRS = 0


def _codes(seq: str) -> np.ndarray:
    return LETTER_INDEX[np.frombuffer(seq.encode("latin-1"), np.uint8)]


def _dp_matrices(q, r, mat, gap_open, gap_extend):
    """Wavefront (anti-diagonal) Gotoh DP: every anti-diagonal is a fully
    vectorized update, so the Python loop count is m+n rather than m*n.
    Returns the filled (H, E, F) matrices."""
    m, n = len(q), len(r)
    H = np.zeros((m + 1, n + 1), dtype=np.int32)
    E = np.full((m + 1, n + 1), NEG_INF, dtype=np.int32)  # gap in query (left)
    F = np.full((m + 1, n + 1), NEG_INF, dtype=np.int32)  # gap in ref (up)
    sub = mat[q][:, r]  # [m, n] substitution scores

    for d in range(2, m + n + 1):  # cells with i+j == d, 1<=i<=m, 1<=j<=n
        i_lo = max(1, d - n)
        i_hi = min(m, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        e = np.maximum(H[i, j - 1] - gap_open, E[i, j - 1] - gap_extend)
        f = np.maximum(H[i - 1, j] - gap_open, F[i - 1, j] - gap_extend)
        h = np.maximum(
            np.maximum(0, H[i - 1, j - 1] + sub[i - 1, j - 1]),
            np.maximum(e, f),
        )
        E[i, j] = e
        F[i, j] = f
        H[i, j] = h
    return H, E, F


def _smith_waterman(
    q: np.ndarray, r: np.ndarray, mat: np.ndarray, gap_open: int, gap_extend: int
) -> Tuple[int, list, list]:
    """Gotoh local alignment.  q, r: LETTER_INDEX arrays.  Returns
    (best_score, q_aln_ops, r_aln_ops) where ops are index lists with -1 for
    gap columns, covering the local alignment region only."""
    H, E, F = _dp_matrices(q, r, mat, gap_open, gap_extend)
    sub = mat[q][:, r]

    best = int(H.max())
    if best <= 0:
        return 0, [], []
    i, j = np.unravel_index(int(H.argmax()), H.shape)
    i, j = int(i), int(j)

    q_ops: list = []
    r_ops: list = []
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            h = H[i, j]
            if h == 0:
                break
            if h == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                q_ops.append(i - 1)
                r_ops.append(j - 1)
                i -= 1
                j -= 1
            elif h == E[i, j]:
                state = "E"
            elif h == F[i, j]:
                state = "F"
            else:  # pragma: no cover - defensive
                break
        elif state == "E":
            q_ops.append(-1)
            r_ops.append(j - 1)
            if E[i, j] == H[i, j - 1] - gap_open:
                state = "H"
            j -= 1
        else:  # state == "F"
            q_ops.append(i - 1)
            r_ops.append(-1)
            if F[i, j] == H[i - 1, j] - gap_open:
                state = "H"
            i -= 1
    q_ops.reverse()
    r_ops.reverse()
    return best, q_ops, r_ops


def align_batch_dispatch(pairs, db_stats, sub_matrix: str, gap_open: int,
                         gap_extend: int, *, device):
    """Enqueue the device DP for a pair batch on `device` (or leave it to
    the host DP under the routing rule); returns a handle for
    align_batch_resolve.  Raises NoMatrixError for an unknown matrix."""
    scores = get_matrix_scores(sub_matrix, gap_open, gap_extend)
    pairs = [(q.replace("U", "*").replace("u", "*"),
              r.replace("U", "*").replace("u", "*")) for q, r in pairs]
    dev = None
    if len(pairs) >= 4 and max(max(len(q), len(r))
                               for q, r in pairs) <= MAX_LEN:
        dev = sw_batch_dispatch([_codes(q) for q, _ in pairs],
                                [_codes(r) for _, r in pairs], scores, device)
    return pairs, scores, db_stats, dev


def align_batch_resolve(handle):
    """Finish an align_batch_dispatch: fetch the device paths (or run the
    host DP) and build the AlignmentResults."""
    global HOST_DP_PAIRS
    pairs, scores, db_stats, dev = handle
    if dev is not None:
        ops = sw_batch_resolve(dev)
    else:
        HOST_DP_PAIRS += len(pairs)
        ops = [_smith_waterman(_codes(q), _codes(r), scores.sub_matrix,
                               scores.gap_open, scores.gap_extend)
               for q, r in pairs]
    return [result_from_ops(q, r, scores, q_ops, r_ops, db_stats)
            for (q, r), (_, q_ops, r_ops) in zip(pairs, ops)]


def align_batch(pairs, db_stats: KStats, sub_matrix: str = "blosum62",
                gap_open: int = 11, gap_extend: int = 1, *, device):
    """Align many (query, ref) pairs on `device` under the routing rule
    (sw_align on a CUDA device, its plain version on the CPU, the host DP
    for small or long batches); returns a list of AlignmentResult
    (kaamer_tpu/ops/swalign.py:147)."""
    return align_batch_resolve(align_batch_dispatch(
        pairs, db_stats, sub_matrix, gap_open, gap_extend, device=device))


def align(query_seq: str, ref_seq: str, db_stats: KStats,
          sub_matrix: str = "blosum62", gap_open: int = 11,
          gap_extend: int = 1, *, device) -> AlignmentResult:
    """One pair's AlignmentResult (kaamer_tpu/ops/swalign.py:125): a batch
    of one, which the routing rule sends to the host DP."""
    return align_batch([(query_seq, ref_seq)], db_stats, sub_matrix,
                       gap_open, gap_extend, device=device)[0]


def result_from_ops(
    query_seq: str, ref_seq: str, scores: MatrixScores,
    q_ops, r_ops, db_stats: KStats,
) -> AlignmentResult:
    """Build the reference-formula result fields from an alignment path."""
    if not q_ops:
        return AlignmentResult()
    qb = np.frombuffer(query_seq.encode("latin-1"), dtype=np.uint8)
    rb = np.frombuffer(ref_seq.encode("latin-1"), dtype=np.uint8)
    q = LETTER_INDEX[qb]
    r = LETTER_INDEX[rb]
    qo = np.asarray(q_ops, dtype=np.int64)
    ro = np.asarray(r_ops, dtype=np.int64)

    # one vectorized pass replaces three per-character Python loops: the
    # -aln serving stream finalizes thousands of pairs per second on a
    # 2-core host, and ~300 iterations/pair was its dominant host term
    GAP = np.uint8(ord("-"))
    a_bytes = np.where(qo >= 0, qb[np.maximum(qo, 0)], GAP)
    b_bytes = np.where(ro >= 0, rb[np.maximum(ro, 0)], GAP)
    a_string = a_bytes.tobytes().decode("latin-1")
    b_string = b_bytes.tobytes().decode("latin-1")

    # identity / similarity / mismatches (align.go:82-101); the reference
    # accumulates float32 1.0s -- exact integers, so integer counts cast
    # through float32 are bit-identical
    mat = scores.sub_matrix
    eq = a_bytes == b_bytes
    both = (a_bytes != GAP) & (b_bytes != GAP)
    mismatches = int((~eq & both).sum())
    positive = mat[LETTER_INDEX[b_bytes], LETTER_INDEX[a_bytes]] > 0
    n_id = int(eq.sum())
    n_sim = n_id + int((~eq & positive).sum())
    match_bytes = np.where(eq, b_bytes,
                           np.where(positive, np.uint8(ord("+")),
                                    np.uint8(ord(" "))))
    nb_pos = np.float32(len(a_string))
    identity = float(np.float32(n_id) / nb_pos * np.float32(100))
    similarity = float(np.float32(n_sim) / nb_pos * np.float32(100))
    aln_string = (f"{a_string}\n"
                  f"{match_bytes.tobytes().decode('latin-1')}\n{b_string}")

    # raw score + gap openings (align.go:105-132 semantics): every gapped
    # column costs gap_extend except the first of each run (gap_open)
    gap = ~both
    gap_start = gap & ~np.concatenate([[False], gap[:-1]])
    gap_openings = int(gap_start.sum())
    n_gap = int(gap.sum())
    raw = int(mat[q[qo[both]], r[ro[both]]].sum(dtype=np.int64))
    raw -= gap_openings * scores.gap_open + (n_gap - gap_openings) * scores.gap_extend

    bitscore = (scores.lam * raw - math.log(scores.K)) / math.log(2)
    evalue = float(len(query_seq)) * float(db_stats.NumberOfAA) / math.pow(2, bitscore)

    q_idx = qo[qo >= 0]
    r_idx = ro[ro >= 0]

    return AlignmentResult(
        Identity=identity,
        Similarity=similarity,
        Length=len(a_string),
        Mismatches=mismatches,
        GapOpenings=gap_openings,
        Raw=raw,
        BitScore=bitscore,
        EValue=evalue,
        AlnString=aln_string,
        QueryStart=int(q_idx[0]) + 1 if q_idx.size else 0,
        QueryEnd=int(q_idx[-1]) + 1 if q_idx.size else 0,
        SubjectStart=int(r_idx[0]) + 1 if r_idx.size else 0,
        SubjectEnd=int(r_idx[-1]) + 1 if r_idx.size else 0,
    )
