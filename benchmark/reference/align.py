"""The alignment a kaamer server gives each kept hit with -aln
(pkg/align/align.go:46-161), worked out here with NumPy from the
algorithm and the formulas, for the judge of -aln answers.

Local alignment with affine gaps (Gotoh) over int32, every cell (i, j),
1 <= i <= len(query), 1 <= j <= len(subject), from row 0 and column 0 at
H = 0 and E = F = NEG:

    E(i, j) = max(H(i, j-1) - open, E(i, j-1) - extend)   gap in the query
    F(i, j) = max(H(i-1, j) - open, F(i-1, j) - extend)   gap in the subject
    H(i, j) = max(0, H(i-1, j-1) + s(q[i], r[j]), E(i, j), F(i, j))

Ties, written out:
- the start cell is the largest H, then the lowest i, then the first j;
- the walk back is in one of three states, starting in H.  In H it stops
  at H = 0; else it steps diagonally where H = H(i-1, j-1) + s, else moves
  to E where H = E, else to F.  In E it takes the column (gap in the
  query, subject residue j) and returns to H where E = H(i, j-1) - open,
  then steps left; in F likewise with (query residue i, gap) and F =
  H(i-1, j) - open, then steps up.  It ends where i or j reaches 0.

The fields of a path of L columns (align.go:82-141): identity and
similarity as float32 percentages of L (a column is similar where its two
residues score above 0 in the matrix; a gap column is looked up as 'X',
which scores no residue above 0 in BLOSUM62); mismatches, the residue
columns of two different letters; gap openings, the maximal runs of gap
columns; the raw score, the matrix scores of the residue columns less
open + (g - 1) * extend a run of g gap columns; the bit score (lambda * S
- ln K) / ln 2; and the E-value m * n / 2^S', m the query's length and n
the database's residue count.  Start and end are 1-based.

Departures from align.go:
- a letter outside the matrix's alphabet is read as 'X' (align.go
  replaces 'U' by '*' before aligning, as here);
- the pairs are aligned in blocks of similar lengths along
  anti-diagonals, all pairs of a block at once;
- where 2^S' overflows a float64 (S' >= 1024) the E-value is 0, what Go's
  math.Pow (+Inf) gives.

`precision="bfloat16"` is the control: identity, bit score and E-value
rounded to bfloat16 at each step where the reference computes them in
float32 or float64.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"

# NCBI's BLOSUM62 over ALPHABET
BLOSUM62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""
MATRIX = np.array([[int(v) for v in line.split()]
                   for line in BLOSUM62.strip().splitlines()], np.int64)
# a kaamer server's default gaps, and Karlin-Altschul's lambda and K of
# BLOSUM62 with them (NCBI BLAST's published table)
GAP_OPEN, GAP_EXTEND = 11, 1
LAMBDA, K = 0.267, 0.041

NEG = -(10 ** 8)
# cells of the H, E and F grids one block holds (int32 each)
BLOCK_CELLS = 1 << 24

_INDEX = np.full(256, ALPHABET.index("X"), dtype=np.int64)
for _k, _c in enumerate(ALPHABET):
    _INDEX[ord(_c)] = _k


class Alignment(NamedTuple):
    identity: float      # float32 percentage
    similarity: float
    length: int
    mismatches: int
    gap_openings: int
    raw: int
    bitscore: float
    evalue: float
    qstart: int
    qend: int
    sstart: int
    send: int


EMPTY = Alignment(0.0, 0.0, 0, 0, 0, 0, 0.0, 0.0, 0, 0, 0, 0)


def codes(seq: str) -> np.ndarray:
    return _INDEX[np.frombuffer(seq.encode("latin-1"), np.uint8)]


def _blocks(pairs: Sequence[Tuple[str, str]]) -> List[List[int]]:
    """Pair indices in blocks of similar lengths, each block's grids of at
    most BLOCK_CELLS cells (a longer pair alone)."""
    order = sorted(range(len(pairs)),
                   key=lambda b: (len(pairs[b][0]), len(pairs[b][1])))
    out, cur, m, n = [], [], 0, 0
    for b in order:
        mm, nn = max(m, len(pairs[b][0])), max(n, len(pairs[b][1]))
        if cur and (len(cur) + 1) * (mm + nn + 1) * (mm + 1) > BLOCK_CELLS:
            out.append(cur)
            cur, mm, nn = [], len(pairs[b][0]), len(pairs[b][1])
        cur.append(b)
        m, n = mm, nn
    if cur:
        out.append(cur)
    return out


def paths(pairs: Sequence[Tuple[str, str]], mat: np.ndarray,
          gap_open: int, gap_extend: int):
    """Per pair (score, query index per column, subject index per column),
    -1 for a gap, the columns in order; (0, [], []) where no cell is
    positive."""
    out: List = [None] * len(pairs)
    for block in _blocks(pairs):
        for b, p in zip(block, _block_paths([pairs[b] for b in block], mat,
                                            gap_open, gap_extend)):
            out[b] = p
    return out


def _block_paths(pairs, mat, gap_open, gap_extend):
    """The DP of a block of pairs, one anti-diagonal d = i + j at a time
    for all pairs at once: the grids are kept skewed, cell (i, j) of pair
    b at [i + j, b, i], so that a diagonal and the two before it are
    slices."""
    B = len(pairs)
    M = max(len(q) for q, _ in pairs)
    N = max(len(r) for _, r in pairs)
    D = M + N + 1
    qc = np.zeros((B, M + 1), np.int64)
    rc = np.zeros((B, N + 1), np.int64)
    for b, (q, r) in enumerate(pairs):
        qc[b, 1:len(q) + 1] = codes(q)
        rc[b, 1:len(r) + 1] = codes(r)
    m = np.array([len(q) for q, _ in pairs])
    n = np.array([len(r) for _, r in pairs])
    A = mat.shape[0]
    S = mat.reshape(-1).astype(np.int32)
    H = np.zeros((D, B, M + 1), np.int32)
    E = np.full_like(H, NEG)
    F = np.full_like(H, NEG)
    for d in range(2, D):
        lo, hi = max(1, d - N), min(M, d - 1)
        if lo > hi:
            continue
        # cells (i, d - i), i = lo .. hi; j runs down from d - lo
        e = np.maximum(H[d - 1, :, lo:hi + 1] - gap_open,
                       E[d - 1, :, lo:hi + 1] - gap_extend)
        f = np.maximum(H[d - 1, :, lo - 1:hi] - gap_open,
                       F[d - 1, :, lo - 1:hi] - gap_extend)
        s = S[qc[:, lo:hi + 1] * A + rc[:, d - hi:d - lo + 1][:, ::-1]]
        h = np.maximum(np.maximum(H[d - 2, :, lo - 1:hi] + s, e), f)
        H[d, :, lo:hi + 1] = np.maximum(h, 0)
        E[d, :, lo:hi + 1] = e
        F[d, :, lo:hi + 1] = f

    # the start cell: the largest H, then the lowest i, then the first j,
    # over each pair's own cells
    i_of = np.arange(M + 1)[None, None, :]
    j_of = np.arange(D)[:, None, None] - i_of
    order = i_of * (N + 1) + j_of  # row-major rank of cell (i, j)
    own = ((i_of >= 1) & (i_of <= m[None, :, None])
           & (j_of >= 1) & (j_of <= n[None, :, None]))
    Hm = np.where(own, H, -1)
    score = Hm.max(axis=(0, 2))
    first = np.where(Hm == score[None, :, None], order,
                     np.iinfo(np.int64).max).min(axis=(0, 2))
    i, j = first // (N + 1), first % (N + 1)

    # the walk back, every pair in step: state 0 H, 1 E, 2 F
    rows = np.arange(B)
    st = np.zeros(B, np.int64)
    done = score <= 0
    k = np.zeros(B, np.int64)
    L = M + N
    q_out = np.full((B, L + 1), -1, np.int64)
    r_out = np.full_like(q_out, -1)

    def at(G, i, j):  # G(i, j) of every pair
        i, j = np.maximum(i, 0), np.maximum(j, 0)
        return G[i + j, rows, i]

    while True:
        done = done | (i <= 0) | (j <= 0)
        if done.all():
            break
        h = at(H, i, j)
        inH, inE, inF = st == 0, st == 1, st == 2
        stop = inH & (h == 0)
        s = S[qc[rows, np.maximum(i, 0)] * A + rc[rows, np.maximum(j, 0)]]
        diag = inH & ~stop & (h == at(H, i - 1, j - 1) + s)
        to_e = inH & ~stop & ~diag & (h == at(E, i, j))
        to_f = inH & ~stop & ~diag & ~to_e
        live = ~done
        emit = live & (diag | inE | inF)
        col = np.where(emit, k, L)
        q_out[rows, col] = np.where(inE, -1, i - 1)
        r_out[rows, col] = np.where(inF, -1, j - 1)
        k += emit
        back = ((inE & (at(E, i, j) == at(H, i, j - 1) - gap_open))
                | (inF & (at(F, i, j) == at(H, i - 1, j) - gap_open)))
        new_st = np.where(to_e, 1, np.where(to_f, 2, np.where(back, 0, st)))
        st = np.where(live, new_st, st)
        i = i - (live & (diag | inF))
        j = j - (live & (diag | inE))
        done = done | (live & stop)
    return [(int(sc), q_out[b, :k[b]][::-1].tolist(),
             r_out[b, :k[b]][::-1].tolist()) if sc > 0 else (0, [], [])
            for b, sc in enumerate(score)]


def bf16(x: float) -> float:
    """x rounded to the nearest bfloat16 (ties to even), through float32."""
    a = np.array([x], np.float32)
    u = a.view(np.uint32)
    u += np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    u &= np.uint32(0xFFFF0000)
    return float(a[0])


def fields(query: str, subject: str, q_ops, r_ops, mat: np.ndarray,
           gap_open: int, gap_extend: int, lam: float, K: float,
           n_residues: int, precision: str = "float32") -> Alignment:
    """The result fields of one path (align.go:82-141)."""
    if not q_ops:
        return EMPTY
    qi, ri = codes(query), codes(subject)
    x = ALPHABET.index("X")
    n_id = n_sim = mismatches = raw = runs = 0
    in_gap = False
    for a, b in zip(q_ops, r_ops):
        if a < 0 or b < 0:
            if not in_gap:
                runs += 1
                raw -= gap_open
            else:
                raw -= gap_extend
            in_gap = True
            ca = qi[a] if a >= 0 else x
            cb = ri[b] if b >= 0 else x
            if mat[cb, ca] > 0:
                n_sim += 1
            continue
        in_gap = False
        raw += int(mat[qi[a], ri[b]])
        if query[a] == subject[b]:
            n_id += 1
            n_sim += 1
        else:
            mismatches += 1
            if mat[ri[b], qi[a]] > 0:
                n_sim += 1
    length = len(q_ops)
    qs = [a for a in q_ops if a >= 0]
    rs = [b for b in r_ops if b >= 0]
    if precision == "bfloat16":
        identity = bf16(bf16(bf16(n_id) / bf16(length)) * bf16(100.0))
        similarity = bf16(bf16(bf16(n_sim) / bf16(length)) * bf16(100.0))
        bits = bf16(bf16(bf16(bf16(lam) * bf16(raw)) - bf16(math.log(K)))
                    / bf16(math.log(2)))
        scale = bf16(2.0 ** bits) if bits < 128 else math.inf
        evalue = bf16(bf16(bf16(len(query)) * bf16(n_residues)) / scale)
    else:
        f32 = np.float32
        identity = float(f32(n_id) / f32(length) * f32(100))
        similarity = float(f32(n_sim) / f32(length) * f32(100))
        bits = (lam * raw - math.log(K)) / math.log(2)
        scale = 2.0 ** bits if bits < 1024 else math.inf
        evalue = float(len(query)) * float(n_residues) / scale
    return Alignment(identity, similarity, length, mismatches, runs, raw,
                     bits, evalue, qs[0] + 1, qs[-1] + 1, rs[0] + 1,
                     rs[-1] + 1)


def align_pairs(pairs: Sequence[Tuple[str, str]], n_residues: int,
                precision: str = "float32") -> List[Alignment]:
    """The alignment of each (query, subject) pair, in order, with
    BLOSUM62 and gaps 11/1."""
    pairs = [(q.replace("U", "*").replace("u", "*"),
              r.replace("U", "*").replace("u", "*")) for q, r in pairs]
    found = paths(pairs, MATRIX, GAP_OPEN, GAP_EXTEND)
    return [fields(q, r, qo, ro, MATRIX, GAP_OPEN, GAP_EXTEND, LAMBDA, K,
                   n_residues, precision)
            for (q, r), (_, qo, ro) in zip(pairs, found)]
