"""Faults in the -aln step planted under a run (run.main's `plant`),
each of which the -aln judge has to catch.  Each swaps the program's
alignment of a flush (ops/swalign.align_batch_resolve) for the host DP
with one rule changed, on every pair of at most SHORT residues a side
(the host DP is slow on the CPU; the rest keep the program's
alignment)."""

import numpy as np

from kaamer_tpu_torch.ops import swalign as sw


def _walk(H, E, F, sub, i, j, gap_open, e_first=False):
    q_ops, r_ops, state = [], [], "H"
    while i > 0 and j > 0:
        if state == "H":
            h = H[i, j]
            if h == 0:
                break
            diag = h == H[i - 1, j - 1] + sub[i - 1, j - 1]
            if e_first and h == E[i, j]:
                state = "E"
            elif diag:
                q_ops.append(i - 1)
                r_ops.append(j - 1)
                i, j = i - 1, j - 1
            elif h == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            q_ops.append(-1)
            r_ops.append(j - 1)
            if E[i, j] == H[i, j - 1] - gap_open:
                state = "H"
            j -= 1
        else:
            q_ops.append(i - 1)
            r_ops.append(-1)
            if F[i, j] == H[i - 1, j] - gap_open:
                state = "H"
            i -= 1
    return q_ops[::-1], r_ops[::-1]


SHORT = 1000


def _plant(last_j=False, e_first=False, gap_open=None, shift=0):
    program = sw.align_batch_resolve

    def resolve(handle):
        pairs, scores, db_stats = handle[:3]
        go = scores.gap_open if gap_open is None else gap_open
        out = []
        for (q, r), res in zip(pairs, program(handle)):
            if max(len(q), len(r)) > SHORT:
                out.append(res)
                continue
            qc, rc = sw._codes(q), sw._codes(r)
            H, E, F = sw._dp_matrices(qc, rc, scores.sub_matrix, go,
                                      scores.gap_extend)
            sub = scores.sub_matrix[qc][:, rc]
            best = int(H.max())
            ops = ([], [])
            if best > 0:
                i = int(np.flatnonzero((H == best).any(axis=1))[0])
                js = np.flatnonzero(H[i] == best)
                j = int(js[-1] if last_j else js[0])
                ops = _walk(H, E, F, sub, i, j, go, e_first)
            res = sw.result_from_ops(q, r, scores._replace(gap_open=go),
                                     *ops, db_stats)
            if res.QueryStart:
                res.QueryStart += shift
            out.append(res)
        return out
    return resolve


def last_j(engine):
    """The start cell on the last column of its row that reaches the
    maximum."""
    sw.align_batch_resolve = _plant(last_j=True)


def e_before_diagonal(engine):
    """The walk leaves H for E where the diagonal ties with E."""
    sw.align_batch_resolve = _plant(e_first=True)


def gap_open_10(engine):
    """Gaps opened at 10 in place of 11."""
    sw.align_batch_resolve = _plant(gap_open=10)


def qstart_off_by_one(engine):
    """Every QStart one past the alignment's first query residue."""
    sw.align_batch_resolve = _plant(shift=1)
