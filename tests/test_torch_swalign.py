"""Smith-Waterman: the torch port's plain wavefront and traceback vs the
Pallas kernel (interpret mode) and the host DP.  Exact equality: scores,
direction bytes and alignment paths are integers.  The CUDA kernel
(sw_align) is held against their composition in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaamer_tpu.ops import swalign as host_sw
from kaamer_tpu.ops.matrices import LETTER_INDEX, get_matrix_scores
from kaamer_tpu.ops.swalign_pallas import _build_full, align_pairs
from kaamer_tpu.records import KStats
from kaamer_tpu_torch.ops import swalign as tsw
from kaamer_tpu_torch.ops import swalign_cuda as swc

AA = "ACDEFGHIKLMNPQRSTVWY"
SCORES = get_matrix_scores("blosum62", 11, 1)


def _codes(s):
    return LETTER_INDEX[np.frombuffer(s.encode(), np.uint8)]


def _pairs(rng, n, lo=30, hi=90):
    """Half related pairs (point mutations and a deletion), half unrelated,
    plus the fixed cases of tests/test_swalign_pallas.py."""
    pairs = []
    for t in range(n):
        base = "".join(rng.choice(list(AA), size=int(rng.integers(lo, hi))))
        if t % 2:
            other = "".join(rng.choice(list(AA),
                                       size=int(rng.integers(lo, hi))))
        else:
            m = list(base)
            for _ in range(int(rng.integers(0, 6))):
                m[int(rng.integers(0, len(m)))] = AA[int(rng.integers(0, 20))]
            if len(m) > 20:
                del m[5:9]
            other = "".join(m)
        pairs.append((base, other))
    seq = "MELPNIMHPVAKLSTALAAALMLSGCMPGEIRPTIGQQME"
    return pairs + [(seq, seq), ("WWWW", "PPPP")]


def _tensors(pairs, device="cpu"):
    arrays = swc.pad_pairs([_codes(q) for q, _ in pairs],
                           [_codes(r) for _, r in pairs])
    mat = torch.from_numpy(SCORES.sub_matrix.astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays] + [mat.to(device)]


def _valid_mask(qlens, rlens, d_pad, W):
    d = np.arange(d_pad)[None, :, None]
    i = np.arange(W)[None, None, :]
    j = d - i
    q = np.asarray(qlens)[:, None, None]
    r = np.asarray(rlens)[:, None, None]
    return (i >= 1) & (i <= q) & (j >= 1) & (j <= r)


def _assert_same_wavefront(dirs_a, best_a, dirs_b, best_b, qlens, rlens):
    """The kernels' contract: valid cells of dirs, lanes 0..qlen of best."""
    B, d_pad, W = dirs_a.shape
    valid = _valid_mask(qlens, rlens, d_pad, W)
    np.testing.assert_array_equal(dirs_a[valid], dirs_b[valid])
    lanes = np.arange(W)[None, :] <= np.asarray(qlens)[:, None]
    for c in (0, 1):
        np.testing.assert_array_equal(best_a[:, c][lanes], best_b[:, c][lanes])


def test_plain_wavefront_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    pairs = _pairs(rng, 4)
    qc, rc, ql, rl, mat = _tensors(pairs)
    B, m_pad = qc.shape
    n_pad = rc.shape[1]
    d_pad = swc._d_pad(m_pad, n_pad)
    full = _build_full(B, m_pad, n_pad, d_pad, SCORES.gap_open,
                       SCORES.gap_extend, interpret=True)
    want_dirs, want_best = full(
        jnp.asarray(qc.numpy().astype(np.int32)),
        jnp.asarray(rc.numpy().astype(np.int32)),
        jnp.asarray(ql.numpy()[None, :]), jnp.asarray(rl.numpy()[None, :]),
        jnp.asarray(SCORES.sub_matrix))
    dirs, best = swc.sw_wavefront_plain(qc, rc, ql, rl, mat,
                                        SCORES.gap_open, SCORES.gap_extend)
    assert dirs.shape == want_dirs.shape and best.shape == want_best.shape
    _assert_same_wavefront(dirs.numpy(), best.numpy(), np.asarray(want_dirs),
                           np.asarray(want_best), ql.numpy(), rl.numpy())


def test_plain_ops_match_pallas_and_host_dp():
    rng = np.random.default_rng(4)
    pairs = _pairs(rng, 6)
    qs = [_codes(q) for q, _ in pairs]
    rs = [_codes(r) for _, r in pairs]
    got = swc.sw_batch_resolve(swc.sw_batch_dispatch(qs, rs, SCORES, "cpu"))
    pallas = align_pairs(pairs, SCORES, interpret=True)
    assert got == pallas
    for (q, r), (score, q_ops, r_ops) in zip(zip(qs, rs), got):
        assert (score, q_ops, r_ops) == host_sw._smith_waterman(
            q, r, SCORES.sub_matrix, SCORES.gap_open, SCORES.gap_extend)
    seq_case, no_hit = got[-2], got[-1]
    n = len(pairs[-2][0])
    assert seq_case[1] == list(range(n)) and seq_case[2] == list(range(n))
    assert no_hit == (0, [], [])


def test_routing_rule_counts_host_pairs():
    """< 4 pairs or a sequence past 2048 residues go to the host DP and are
    counted; a device batch is not."""
    rng = np.random.default_rng(8)
    pairs = _pairs(rng, 4)
    stats = KStats(NumberOfAA=10**6)
    before = tsw.HOST_DP_PAIRS
    dev = tsw.align_batch_resolve(tsw.align_batch_dispatch(
        pairs, stats, "blosum62", 11, 1, device="cpu"))
    assert tsw.HOST_DP_PAIRS == before
    few = tsw.align_batch_resolve(tsw.align_batch_dispatch(
        pairs[:3], stats, "blosum62", 11, 1, device="cpu"))
    assert tsw.HOST_DP_PAIRS == before + 3
    assert few == dev[:3]
    long_q = "".join(rng.choice(list(AA), size=2049))
    handle = tsw.align_batch_dispatch([(long_q, long_q)] * 4, stats,
                                      "blosum62", 11, 1, device="cpu")
    assert handle[3] is None  # left to the host DP
    with pytest.raises(tsw.NoMatrixError):
        tsw.align_batch_dispatch(pairs, stats, "nosuch", 11, 1, device="cpu")

