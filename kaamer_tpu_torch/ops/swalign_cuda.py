"""Batched Smith-Waterman on the device (kaamer_tpu/ops/swalign_pallas.py).

One kernel, sw_align (csrc/swalign.cu): Gotoh affine-gap local alignment
of B pairs and its traceback, returning (score int32[B], q_ops int16[B,
d_pad], r_ops int16[B, d_pad], n_ops int32[B]).  Its plain version is the
composition of two plain functions that mirror the JAX package step for
step and are held against it on the CPU:

  sw_wavefront_plain  _kernel's anti-diagonal DP, vectorized over (B, W):
                      direction bytes dirs uint8[B, d_pad, W] and per-lane
                      best scores best int32[B, 2, W] in the Pallas layout
  sw_traceback_plain  _build_traceback's lockstep walk over dirs

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
version.  The kernel keeps its directions on chip as nibbles in a
step-major layout of its own; pack_dirs_nibbles and sw_walk_nibbles_plain
rebuild that layout and walk it in torch, so the kernel's index
arithmetic is under CPU tests too.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..upload import upload, upload_all
from . import _kernels
from .matrices import MatrixScores

NEG = -(10**8)
MAX_LEN = 2048
N_LETTERS = 24

# kernel launches by wrapper (not counting plain-version calls)
launches = {"sw_align": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _d_pad(m_pad: int, n_pad: int) -> int:
    return ((m_pad + n_pad + 1 + 7) // 8) * 8


def rows_per_lane(m_pad: int) -> int:
    """The kernel's R, query rows per lane of its warp: 4 * ceil(m_pad /
    128), pad_pairs' 128-buckets, at most 64 (2048 rows: a longer query
    goes to the host DP)."""
    return min(64, 4 * -(-m_pad // 128))


def _check_args(qcodes, rcodes, qlens, rlens, mat):
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
    (invalid cells h = 0, e = f = NEG), as in the Pallas kernel.  Returns
    (dirs uint8[B, d_pad, W], best int32[B, 2, W]): per cell (i, j) at
    [b, i + j, i] bits 0-1 the H origin (0 stop, 1 diag, 2 E, 3 F), bit 2
    E continued from E, bit 3 F from F; per query lane i the best H and
    the first diagonal reaching it."""
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


def _walk_plain(read, score, i, j, S: int):
    """_build_traceback's lockstep walk from the start cells (i, j) of
    pairs scoring `score`; read(i, j) gives the direction bits of cell
    (i, j) (int64[B]).  All pairs walk together (the walk stops early once
    every pair is done, which changes no output).  Returns (score int32,
    q_ops int16[B, S], r_ops, n_ops int32); ops past n_ops are -1."""
    B = score.shape[0]
    dev = score.device
    st = torch.zeros(B, dtype=torch.long, device=dev)  # 0 H, 1 E, 2 F
    done = score <= 0
    n = torch.zeros(B, dtype=torch.long, device=dev)
    q_buf = torch.full((B, S + 1), -1, dtype=torch.int16, device=dev)
    r_buf = torch.full_like(q_buf, -1)
    for step in range(2 * S):
        alive = ~done & (i > 0) & (j > 0)
        if step % 64 == 0 and not bool(alive.any()):
            break
        bits = read(i, j)
        hdir = bits & 3
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
            torch.where(isE, torch.where((bits & 4) > 0, 1, 0),
                        torch.where((bits & 8) > 0, 2, 0)))
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


def sw_traceback_plain(dirs, best, qlens):
    """swalign_pallas.py:_build_traceback as torch ops: the walk starts at
    the first lane (lowest i) holding the maximum best, at the diagonal
    best records for it.  Returns (score int32[B], q_ops int16[B, d_pad],
    r_ops int16[B, d_pad], n_ops int32[B]); ops past n_ops are -1."""
    B, d_pad, W = dirs.shape
    lane = torch.arange(W, device=dirs.device)[None, :]
    bv = torch.where(lane <= qlens.long()[:, None], best[:, 0, :], -1)
    score = bv.max(dim=1).values
    # first maximum: lowest i
    i = torch.where(bv == score[:, None], lane, W).min(dim=1).values
    j = best[:, 1, :].gather(1, i[:, None])[:, 0].long() - i
    flat = dirs.reshape(B, -1)

    def read(i, j):
        idx = ((i + j) * W + i).clamp(0, d_pad * W - 1)
        return flat.gather(1, idx[:, None])[:, 0].long()

    return _walk_plain(read, score, i, j, d_pad)


def sw_align_plain(qcodes, rcodes, qlens, rlens, mat, gap_open: int,
                   gap_extend: int):
    """sw_align's plain version: sw_traceback_plain(*sw_wavefront_plain)."""
    dirs, best = sw_wavefront_plain(qcodes, rcodes, qlens, rlens, mat,
                                    gap_open, gap_extend)
    return sw_traceback_plain(dirs, best, qlens)


def pack_dirs_nibbles(dirs, qlens, rlens, R: int):
    """sw_wavefront_plain's direction bytes in the kernel's on-chip layout
    for R rows a lane: int64[B, steps, ceil(R/8), 32] holding uint32 words,
    steps = max(rlens) + 31.  Cell (i, j), lane k = (i-1) // R, t = (i-1)
    % R, sits at step s = j - 1 + k, word t // 8, lane k, bits 4 (t % 8)
    .. +3; cells outside 1 <= i <= qlen, 1 <= j <= rlen are 0."""
    B, d_pad, W = dirs.shape
    dev = dirs.device
    nw = (R + 7) // 8
    n_cols = int(rlens.max()) if B else 0
    steps = n_cols + 31
    i = torch.arange(1, 32 * R + 1, device=dev)[None, :, None]
    j = torch.arange(1, n_cols + 1, device=dev)[None, None, :]
    valid = ((i < W) & (i <= qlens.long()[:, None, None])
             & (j <= rlens.long()[:, None, None]))
    d = (i + j).clamp(max=d_pad - 1)
    flat = dirs.long().reshape(B, -1)
    nib = flat.gather(1, (d * W + i.clamp(max=W - 1)).expand(
        B, -1, -1).reshape(B, -1)).reshape(valid.shape)
    nib = torch.where(valid, nib, 0)
    k = (i - 1) // R
    t = (i - 1) % R
    pos = ((j - 1 + k) * nw + t // 8) * 32 + k
    words = torch.zeros((B, steps * nw * 32), dtype=torch.int64, device=dev)
    words.scatter_add_(1, pos.expand(B, -1, -1).reshape(B, -1),
                       (nib << (4 * (t % 8))).reshape(B, -1))
    return words.reshape(B, steps, nw, 32)


def sw_walk_nibbles_plain(words, best, qlens, R: int, d_pad: int):
    """The kernel's start-cell choice and walk over pack_dirs_nibbles'
    layout: each lane's maximum over its R rows of key = h << 11 | (2047 -
    (i - 1)) (rows past qlen do not count), the warp's maximum key, score
    and i decoded from it, j from best's diagonal; then the walk of
    sw_traceback_plain, reading nibbles.  Equals sw_traceback_plain(dirs,
    best, qlens)."""
    B, steps, nw, _ = words.shape
    W = best.shape[2]
    dev = words.device
    rows = torch.arange(1, 32 * R + 1, device=dev)
    ok = (rows < W)[None, :] & (rows[None, :] <= qlens.long()[:, None])
    bv = torch.where(ok, best[:, 0, rows.clamp(max=W - 1)].long(), 0)
    keys = (bv << 11) + (2047 - (rows - 1))
    key = keys.reshape(B, 32, R).max(dim=2).values.max(dim=1).values
    score = key >> 11
    i = torch.where(score > 0, 2048 - (key & 2047), 0)
    j = best[:, 1, :].gather(1, i.clamp(max=W - 1)[:, None])[:, 0].long() - i
    flat = words.reshape(B, -1)

    def read(i, j):
        k = (i - 1).clamp(min=0) // R
        t = (i - 1).clamp(min=0) % R
        s = (j - 1 + k).clamp(0, steps - 1)
        w = flat.gather(1, ((s * nw + t // 8) * 32 + k)[:, None])[:, 0]
        return (w >> (4 * (t % 8))) & 15

    return _walk_plain(read, score, i, j, d_pad)


def check_lengths(q_max: int, r_max: int, m_pad: int, n_pad: int) -> None:
    """Raise unless the longest query and reference fit their pads and
    MAX_LEN."""
    if q_max > min(m_pad, MAX_LEN) or r_max > min(n_pad, MAX_LEN):
        raise ValueError(f"lengths ({q_max}, {r_max}) exceed the pads "
                         f"({m_pad}, {n_pad}) or {MAX_LEN}")


def sw_align(qcodes, rcodes, qlens, rlens, mat, gap_open: int,
             gap_extend: int, *, lengths_checked: bool = False):
    """Smith-Waterman scores and alignment paths of B pairs.

    qcodes uint8[B, m_pad], rcodes uint8[B, n_pad] LETTER_INDEX codes;
    qlens/rlens int32[B] (<= m_pad, <= n_pad, <= 2048); mat int32[24, 24].
    Returns (score int32[B], q_ops int16[B, d_pad], r_ops int16[B, d_pad],
    n_ops int32[B]), d_pad = ceil8(m_pad + n_pad + 1): the first n_ops[b]
    entries of q_ops/r_ops are the forward path (-1 marks a gap column);
    entries past n_ops are undefined on CUDA.

    The lengths are checked by reading their maxima from the tensors,
    which on a card waits for the stream; a caller that has checked them
    on the host (sw_batch_dispatch) passes lengths_checked=True and the
    call only enqueues work."""
    _check_args(qcodes, rcodes, qlens, rlens, mat)
    B, m_pad = qcodes.shape
    n_pad = rcodes.shape[1]
    if B and m_pad >= MAX_LEN + 128:
        raise ValueError(f"m_pad {m_pad} is beyond the kernel's lanes")
    dev = qcodes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if B and not lengths_checked:
        check_lengths(*torch.stack([qlens.max(), rlens.max()]).tolist(),
                      m_pad, n_pad)
    if dev.type == "cpu":
        return sw_align_plain(qcodes, rcodes, qlens, rlens, mat, gap_open,
                              gap_extend)
    d_pad = _d_pad(m_pad, n_pad)
    R = rows_per_lane(m_pad)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    n_ops = torch.empty(B, dtype=torch.int32, device=dev)
    q_ops = torch.empty((B, d_pad), dtype=torch.int16, device=dev)
    r_ops = torch.empty((B, d_pad), dtype=torch.int16, device=dev)
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        warps, use_smem = ctypes.c_int(1), ctypes.c_int(0)
        _kernels.check(lib.kt_sw_align_plan(R, B, n_pad, ctypes.byref(warps),
                                            ctypes.byref(use_smem)),
                       "sw_align plan")
        # direction words that do not fit in shared memory: global scratch
        scratch = None if use_smem.value else torch.empty(
            B * lib.kt_sw_align_pair_bytes(R, n_pad), dtype=torch.uint8,
            device=dev)
        rc = lib.kt_sw_align(
            qcodes.data_ptr(), rcodes.data_ptr(), qlens.data_ptr(),
            rlens.data_ptr(), mat.data_ptr(), B, m_pad, n_pad, d_pad, R,
            int(gap_open), int(gap_extend), use_smem.value, warps.value,
            None if scratch is None else scratch.data_ptr(),
            score.data_ptr(), q_ops.data_ptr(), r_ops.data_ptr(),
            n_ops.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "sw_align")
    launches["sw_align"] += 1
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


# substitution matrices on their devices, by (device, matrix bytes, gaps)
_MATRICES: dict = {}


def _device_matrix(scores: MatrixScores, device) -> torch.Tensor:
    """The substitution matrix as int32[24, 24] on `device`, uploaded once
    per (device, matrix, gaps)."""
    sub = np.ascontiguousarray(scores.sub_matrix, dtype=np.int32)
    key = (torch.device(device), sub.tobytes(), scores.gap_open,
           scores.gap_extend)
    mat = _MATRICES.get(key)
    if mat is None:
        mat = _MATRICES[key] = upload(sub, device)
    return mat


def sw_batch_dispatch(qs: List[np.ndarray], rs: List[np.ndarray],
                      scores: MatrixScores, device):
    """Check the pair lengths on the host, upload the batch and enqueue the
    alignment on `device`; sw_batch_resolve finishes.  Nothing here waits
    for the card.  Returns the device-side op arrays."""
    qcodes, rcodes, qlens, rlens = pad_pairs(qs, rs)
    if len(qs):
        check_lengths(int(qlens.max()), int(rlens.max()), qcodes.shape[1],
                      rcodes.shape[1])
    qcodes, rcodes, qlens, rlens = upload_all((qcodes, rcodes, qlens, rlens),
                                              device)
    return sw_align(qcodes, rcodes, qlens, rlens,
                    _device_matrix(scores, device), scores.gap_open,
                    scores.gap_extend, lengths_checked=True)


def sw_batch_resolve(handle) -> List[Tuple[int, list, list]]:
    """Fetch the op arrays; per pair (best_score, q_ops, r_ops) like
    ops.swalign._smith_waterman."""
    score, q_ops, r_ops, n_ops = (t.cpu().numpy() for t in handle)
    out = []
    for b, s in enumerate(score.tolist()):
        if s <= 0:
            out.append((0, [], []))
            continue
        n = int(n_ops[b])
        out.append((s, q_ops[b, :n].tolist(), r_ops[b, :n].tolist()))
    return out
