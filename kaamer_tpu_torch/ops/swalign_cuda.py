"""Batched Smith-Waterman on the device (kaamer_tpu/ops/swalign_pallas.py).

Two kernels, each with a plain-torch twin of the same signature:

  sw_wavefront  Gotoh affine-gap DP along anti-diagonals; emits the packed
                direction bytes dirs uint8[B, d_pad, W] and the per-lane
                best scores best int32[B, 2, W] in the Pallas kernel's
                layout (csrc/swalign.cu states the bit layout)
  sw_traceback  walks dirs from the best cell of each pair; emits the
                alignment path as int16 op lists plus its length

A CUDA tensor runs the hand-written kernel (csrc/swalign.cu) or raises; a
CPU tensor runs the plain version.  The plain versions mirror the JAX
functions step for step (_kernel's diagonal loop vectorized over (B, W),
_build_traceback's lockstep walk), and are the kernels' oracle.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from kaamer_tpu.ops.matrices import MatrixScores

from . import _kernels

NEG = -(10**8)
MAX_LEN = 2048
N_LETTERS = 24

# kernel launches by wrapper (not counting plain-version calls)
launches = {"sw_wavefront": 0, "sw_traceback": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _d_pad(m_pad: int, n_pad: int) -> int:
    return ((m_pad + n_pad + 1 + 7) // 8) * 8


def _check_wavefront_args(qcodes, rcodes, qlens, rlens, mat):
    B = qcodes.shape[0]
    dev = qcodes.device
    for name, t, dtype, ndim in (("qcodes", qcodes, torch.uint8, 2),
                                 ("rcodes", rcodes, torch.uint8, 2),
                                 ("qlens", qlens, torch.int32, 1),
                                 ("rlens", rlens, torch.int32, 1),
                                 ("mat", mat, torch.int32, 2)):
        if t.dtype != dtype or t.dim() != ndim or t.device != dev:
            raise ValueError(f"{name}: want {dtype} {ndim}-d on {dev}, got "
                             f"{t.dtype} {t.dim()}-d on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (rcodes.shape[0] != B or qlens.shape != (B,) or rlens.shape != (B,)
            or mat.shape != (N_LETTERS, N_LETTERS)):
        raise ValueError("shape mismatch: qcodes [B, m_pad], rcodes "
                         "[B, n_pad], qlens/rlens [B], mat [24, 24]")


def sw_wavefront_plain(qcodes, rcodes, qlens, rlens, mat, gap_open: int,
                       gap_extend: int):
    """swalign_pallas.py:_kernel as torch ops: one vectorized update per
    anti-diagonal over all pairs and query lanes.  Every cell gets a value
    (invalid cells h = 0, e = f = NEG), as in the Pallas kernel."""
    B, m_pad = qcodes.shape
    n_pad = rcodes.shape[1]
    W = m_pad + 1
    d_pad = _d_pad(m_pad, n_pad)
    dev = qcodes.device
    lane = torch.arange(W, device=dev)[None, :]
    ql = qlens.long()[:, None]
    rl = rlens.long()[:, None]
    # lane i scores q[i-1]; lane 0 is never valid
    qrow = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                      qcodes.long()], dim=1) * N_LETTERS
    r = rcodes.long()
    mat_flat = mat.reshape(-1)

    def shift1(x, fill):  # lane i <- lane i-1; lane 0 <- fill
        return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)

    zeros = torch.zeros((B, W), dtype=torch.int32, device=dev)
    h_prev2 = h_prev = best_v = best_d = zeros
    e_prev = f_prev = torch.full_like(zeros, NEG)
    dirs = torch.empty((B, d_pad, W), dtype=torch.uint8, device=dev)
    for d in range(d_pad):
        j = d - lane
        valid = (lane >= 1) & (lane <= ql) & (j >= 1) & (j <= rl)
        rj = r.gather(1, (j - 1).clamp(0, max(n_pad - 1, 0)).expand(B, W))
        sub = mat_flat[qrow + rj]
        e_open = h_prev - gap_open
        f_open = shift1(h_prev, 0) - gap_open
        e = torch.maximum(e_open, e_prev - gap_extend)
        f = torch.maximum(f_open, shift1(f_prev, NEG) - gap_extend)
        h0 = shift1(h_prev2, 0) + sub
        h = torch.maximum(h0.clamp(min=0), torch.maximum(e, f))
        e = torch.where(valid, e, NEG)
        f = torch.where(valid, f, NEG)
        h = torch.where(valid, h, 0)
        hdir = torch.where(h == 0, 0, torch.where(
            h == h0, 1, torch.where(h == e, 2, 3)))
        dirs[:, d, :] = (hdir | ((e != e_open).int() << 2)
                         | ((f != f_open).int() << 3)).to(torch.uint8)
        better = h > best_v
        best_v = torch.where(better, h, best_v)
        best_d = torch.where(better, d, best_d)
        h_prev2, h_prev, e_prev, f_prev = h_prev, h, e, f
    return dirs, torch.stack([best_v, best_d], dim=1)


def sw_wavefront(qcodes, rcodes, qlens, rlens, mat, gap_open: int,
                 gap_extend: int):
    """Direction bytes and per-lane best scores of B pairs.

    qcodes uint8[B, m_pad], rcodes uint8[B, n_pad] LETTER_INDEX codes;
    qlens/rlens int32[B] (<= m_pad, <= n_pad, <= 2048); mat int32[24, 24].
    Returns (dirs uint8[B, d_pad, m_pad + 1], best int32[B, 2, m_pad + 1]),
    d_pad = ceil8(m_pad + n_pad + 1).  On CUDA only valid cells of dirs
    and lanes 0..qlen of best are defined."""
    _check_wavefront_args(qcodes, rcodes, qlens, rlens, mat)
    B, m_pad = qcodes.shape
    n_pad = rcodes.shape[1]
    if B and m_pad >= MAX_LEN + 128:
        raise ValueError(f"m_pad {m_pad} is beyond the kernel's lanes")
    if qcodes.device.type == "cpu":
        return sw_wavefront_plain(qcodes, rcodes, qlens, rlens, mat,
                                  gap_open, gap_extend)
    if qcodes.device.type != "cuda":
        raise ValueError(f"unsupported device {qcodes.device}")
    if B:
        q_max, r_max = torch.stack([qlens.max(), rlens.max()]).tolist()
        if q_max > min(m_pad, MAX_LEN) or r_max > n_pad:
            raise ValueError(f"lengths ({q_max}, {r_max}) exceed the pads "
                             f"({m_pad}, {n_pad}) or {MAX_LEN}")
    W = m_pad + 1
    d_pad = _d_pad(m_pad, n_pad)
    dirs = torch.empty((B, d_pad, W), dtype=torch.uint8, device=qcodes.device)
    best = torch.empty((B, 2, W), dtype=torch.int32, device=qcodes.device)
    lib = _kernels.lib()
    with torch.cuda.device(qcodes.device):
        rc = lib.kt_sw_wavefront(
            qcodes.data_ptr(), rcodes.data_ptr(), qlens.data_ptr(),
            rlens.data_ptr(), mat.data_ptr(), B, m_pad, n_pad, d_pad,
            int(gap_open), int(gap_extend), dirs.data_ptr(), best.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "sw_wavefront")
    launches["sw_wavefront"] += 1
    return dirs, best


def sw_traceback_plain(dirs, best, qlens):
    """swalign_pallas.py:_build_traceback as torch ops: all pairs walk in
    lockstep (the walk stops early once every pair is done, which changes
    no output).  Ops past n_ops are -1."""
    B, d_pad, W = dirs.shape
    dev = dirs.device
    lane = torch.arange(W, device=dev)[None, :]
    bv = torch.where(lane <= qlens.long()[:, None], best[:, 0, :], -1)
    score = bv.max(dim=1).values
    # first maximum: lowest i
    i = torch.where(bv == score[:, None], lane, W).min(dim=1).values
    j = best[:, 1, :].gather(1, i[:, None])[:, 0].long() - i
    st = torch.zeros(B, dtype=torch.long, device=dev)  # 0 H, 1 E, 2 F
    done = score <= 0
    n = torch.zeros(B, dtype=torch.long, device=dev)
    S = d_pad
    q_buf = torch.full((B, S + 1), -1, dtype=torch.int16, device=dev)
    r_buf = torch.full_like(q_buf, -1)
    flat = dirs.reshape(B, -1)
    for step in range(2 * d_pad):
        alive = ~done & (i > 0) & (j > 0)
        if step % 64 == 0 and not bool(alive.any()):
            break
        idx = ((i + j) * W + i).clamp(0, d_pad * W - 1)
        byte = flat.gather(1, idx[:, None])[:, 0].long()
        hdir = byte & 3
        isH, isE, isF = st == 0, st == 1, st == 2
        diag = isH & (hdir == 1)
        stopping = isH & (hdir == 0)
        emit = alive & ~stopping & (diag | isE | isF)
        col = torch.where(emit, n, S)[:, None]
        q_buf.scatter_(1, col, torch.where(isE, -1, i - 1)[:, None].to(torch.int16))
        r_buf.scatter_(1, col, torch.where(isF, -1, j - 1)[:, None].to(torch.int16))
        n = n + emit.long()
        new_st = torch.where(
            isH, torch.where(hdir == 2, 1, torch.where(hdir == 3, 2, 0)),
            torch.where(isE, torch.where((byte & 4) > 0, 1, 0),
                        torch.where((byte & 8) > 0, 2, 0)))
        done = done | stopping | (i <= 0) | (j <= 0)
        i = torch.where(alive & (diag | isF), i - 1, i)
        j = torch.where(alive & (diag | isE), j - 1, j)
        st = torch.where(alive, new_st, st)
    # the walk emits from the alignment end backwards: reverse each prefix
    k = torch.arange(S, device=dev)[None, :]
    src = (n[:, None] - 1 - k).clamp(min=0)
    q_ops = torch.where(k < n[:, None], q_buf.gather(1, src), -1)
    r_ops = torch.where(k < n[:, None], r_buf.gather(1, src), -1)
    return score.int(), q_ops, r_ops, n.int()


def sw_traceback(dirs, best, qlens):
    """Alignment paths of B pairs from sw_wavefront's outputs.

    Returns (score int32[B], q_ops int16[B, d_pad], r_ops int16[B, d_pad],
    n_ops int32[B]): the first n_ops[b] entries of q_ops/r_ops are the
    forward path (-1 marks a gap column); entries past n_ops are
    undefined on CUDA."""
    B, d_pad, W = dirs.shape
    dev = dirs.device
    for name, t, dtype in (("dirs", dirs, torch.uint8),
                           ("best", best, torch.int32),
                           ("qlens", qlens, torch.int32)):
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} on {dev}")
    if best.shape != (B, 2, W) or qlens.shape != (B,):
        raise ValueError("shape mismatch: dirs [B, d_pad, W], best "
                         "[B, 2, W], qlens [B]")
    if dev.type == "cpu":
        return sw_traceback_plain(dirs, best, qlens)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    n_ops = torch.empty(B, dtype=torch.int32, device=dev)
    q_ops = torch.empty((B, d_pad), dtype=torch.int16, device=dev)
    r_ops = torch.empty((B, d_pad), dtype=torch.int16, device=dev)
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        rc = lib.kt_sw_traceback(
            dirs.data_ptr(), best.data_ptr(), qlens.data_ptr(), B, d_pad, W,
            score.data_ptr(), q_ops.data_ptr(), r_ops.data_ptr(),
            n_ops.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "sw_traceback")
    launches["sw_traceback"] += 1
    return score, q_ops, r_ops, n_ops


def pad_pairs(qs: List[np.ndarray], rs: List[np.ndarray]):
    """Host batch of LETTER_INDEX arrays in the JAX package's padded layout:
    W = m_pad + 1 a multiple of 128, n_pad a multiple of 128
    (swalign_pallas.py:277-285).  Returns numpy (qcodes uint8[B, m_pad],
    rcodes uint8[B, n_pad], qlens int32[B], rlens int32[B])."""
    m_max = max(2, max(len(q) for q in qs))
    n_max = max(2, max(len(r) for r in rs))
    m_pad = ((m_max + 1 + 127) // 128) * 128 - 1
    n_pad = ((n_max + 127) // 128) * 128
    B = len(qs)
    qcodes = np.zeros((B, m_pad), dtype=np.uint8)
    rcodes = np.zeros((B, n_pad), dtype=np.uint8)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qcodes[b, :len(q)] = q
        rcodes[b, :len(r)] = r
    qlens = np.fromiter((len(q) for q in qs), dtype=np.int32, count=B)
    rlens = np.fromiter((len(r) for r in rs), dtype=np.int32, count=B)
    return qcodes, rcodes, qlens, rlens


def sw_batch_dispatch(qs: List[np.ndarray], rs: List[np.ndarray],
                      scores: MatrixScores, device):
    """Upload a pair batch and enqueue the DP and traceback on `device`;
    sw_batch_resolve finishes.  Returns the device-side op arrays."""
    arrays = [torch.from_numpy(a).to(device) for a in pad_pairs(qs, rs)]
    qcodes, rcodes, qlens, rlens = arrays
    mat = torch.from_numpy(np.ascontiguousarray(
        scores.sub_matrix, dtype=np.int32)).to(device)
    dirs, best = sw_wavefront(qcodes, rcodes, qlens, rlens, mat,
                              scores.gap_open, scores.gap_extend)
    return sw_traceback(dirs, best, qlens)


def sw_batch_resolve(handle) -> List[Tuple[int, list, list]]:
    """Fetch the op arrays; per pair (best_score, q_ops, r_ops) like
    kaamer_tpu.ops.swalign._smith_waterman."""
    score, q_ops, r_ops, n_ops = (t.cpu().numpy() for t in handle)
    out = []
    for b, s in enumerate(score.tolist()):
        if s <= 0:
            out.append((0, [], []))
            continue
        n = int(n_ops[b])
        out.append((s, q_ops[b, :n].tolist(), r_ops[b, :n].tolist()))
    return out
