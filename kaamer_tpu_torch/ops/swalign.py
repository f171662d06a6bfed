"""Batch alignment for -aln on torch (kaamer_tpu/ops/swalign.py:163-239).

The routing rule is the JAX package's: a batch of at least 4 pairs whose
sequences are all at most 2048 residues runs on the device
(ops/swalign_cuda.py); any other batch runs the host DP
(kaamer_tpu.ops.swalign._smith_waterman) and is counted in
HOST_DP_PAIRS.  Nothing else falls back: a device failure raises.
Result fields come from the shared result_from_ops.
"""

from __future__ import annotations

import numpy as np

from kaamer_tpu.ops.matrices import (LETTER_INDEX, NoMatrixError,
                                     get_matrix_scores)
from kaamer_tpu.ops.swalign import _smith_waterman, result_from_ops

from .swalign_cuda import MAX_LEN, sw_batch_dispatch, sw_batch_resolve

# pairs aligned by the host DP under the routing rule (< 4 pairs or a
# sequence longer than MAX_LEN)
HOST_DP_PAIRS = 0


def _codes(seq: str) -> np.ndarray:
    return LETTER_INDEX[np.frombuffer(seq.encode("latin-1"), np.uint8)]


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

