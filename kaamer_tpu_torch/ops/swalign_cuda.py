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
version (in blocks of pairs of like padded length).  The kernel keeps its directions on chip as nibbles in a step-major layout
of its own, one block of words a strip of 32R query rows;
pack_dirs_nibbles and sw_walk_nibbles_plain rebuild that layout and walk
it in torch, so the kernel's index arithmetic is under CPU tests too.

Every pair whose query and reference are each at most MAX_LEN residues
runs on the device: queries past the warp's 32R rows (R = 64 past 2048
residues) are swept in strips, one after the other.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..trace import span
from ..upload import upload, upload_all
from . import _kernels
from .matrices import MatrixScores

NEG = -(10**8)
# the longest query or reference the kernel takes; its start-cell key keeps
# i - 1 in KEY_BITS bits (csrc/swalign.cu SW_KEY_BITS)
KEY_BITS = 13
MAX_LEN = 1 << KEY_BITS
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
    128), pad_pairs' 128-buckets, at most 64 (a strip of 2048 rows: a
    longer query takes several strips)."""
    return min(64, 4 * -(-m_pad // 128))


def strips(R: int, rows: int) -> int:
    """Strips of 32R query rows that `rows` rows take (at least one)."""
    return max(1, -(-rows // (32 * R)))


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
    """sw_align's plain version: sw_traceback_plain(*sw_wavefront_plain)
    over blocks of pairs whose padded lengths share a power-of-two class,
    each block cut to its own pads, in the batch's shapes (ops past n_ops
    -1).  The wavefront pays for every padded cell of B x W x d_pad, so one
    long pair would set that size for the whole batch; the kernel does not
    (each warp sweeps its own pair)."""
    B, m_pad = qcodes.shape
    dev = qcodes.device
    d_pad = _d_pad(m_pad, rcodes.shape[1])
    out = (torch.zeros(B, dtype=torch.int32, device=dev),
           torch.full((B, d_pad), -1, dtype=torch.int16, device=dev),
           torch.full((B, d_pad), -1, dtype=torch.int16, device=dev),
           torch.zeros(B, dtype=torch.int32, device=dev))
    blocks: dict = {}
    for b, (m, n) in enumerate(zip(qlens.tolist(), rlens.tolist())):
        mp, npd = padded(m, n)
        blocks.setdefault(((mp + 1).bit_length(), npd.bit_length()),
                          []).append(b)
    for idx in blocks.values():
        idx = torch.tensor(idx, device=dev)
        mp, npd = padded(int(qlens[idx].max()), int(rlens[idx].max()))
        ql = qlens[idx]
        dirs, best = sw_wavefront_plain(qcodes[idx, :mp], rcodes[idx, :npd],
                                        ql, rlens[idx], mat, gap_open,
                                        gap_extend)
        for o, g in zip(out, sw_traceback_plain(dirs, best, ql)):
            if g.dim() == 1:
                o[idx] = g
            else:
                o[idx, :g.shape[1]] = g
    return out


def pack_dirs_nibbles(dirs, qlens, rlens, R: int):
    """sw_wavefront_plain's direction bytes in the kernel's layout for R
    rows a lane: int64[B, n_strips * steps, ceil(R/8), 32] holding uint32
    words, steps = max(rlens) + 31 a strip, n_strips = strips(R,
    max(qlens)).  Cell (i, j) lies in strip p = (i-1) // 32R, lane k =
    u // R, t = u % R for u = (i-1) % 32R, at step p * steps + j - 1 + k,
    word t // 8, lane k, bits 4 (t % 8) .. +3; cells outside 1 <= i <=
    qlen, 1 <= j <= rlen are 0."""
    B, d_pad, W = dirs.shape
    dev = dirs.device
    nw = (R + 7) // 8
    n_cols = int(rlens.max()) if B else 0
    steps = n_cols + 31
    n_strips = strips(R, int(qlens.max()) if B else 0)
    i = torch.arange(1, n_strips * 32 * R + 1, device=dev)[None, :, None]
    j = torch.arange(1, n_cols + 1, device=dev)[None, None, :]
    valid = ((i < W) & (i <= qlens.long()[:, None, None])
             & (j <= rlens.long()[:, None, None]))
    d = (i + j).clamp(max=d_pad - 1)
    flat = dirs.long().reshape(B, -1)
    nib = flat.gather(1, (d * W + i.clamp(max=W - 1)).expand(
        B, -1, -1).reshape(B, -1)).reshape(valid.shape)
    nib = torch.where(valid, nib, 0)
    p, u = (i - 1) // (32 * R), (i - 1) % (32 * R)
    k, t = u // R, u % R
    pos = ((p * steps + j - 1 + k) * nw + t // 8) * 32 + k
    words = torch.zeros((B, n_strips * steps * nw * 32), dtype=torch.int64,
                        device=dev)
    words.scatter_add_(1, pos.expand(B, -1, -1).reshape(B, -1),
                       (nib << (4 * (t % 8))).reshape(B, -1))
    return words.reshape(B, n_strips * steps, nw, 32)


def sw_walk_nibbles_plain(words, best, qlens, R: int, d_pad: int):
    """The kernel's start-cell choice and walk over pack_dirs_nibbles'
    layout: the maximum over every strip's rows of key = h << KEY_BITS |
    (MAX_LEN - 1 - (i - 1)) (rows past qlen do not count), score and i
    decoded from it, j from best's diagonal; then the walk of
    sw_traceback_plain, reading nibbles.  Equals sw_traceback_plain(dirs,
    best, qlens)."""
    B, total_steps, nw, _ = words.shape
    W = best.shape[2]
    dev = words.device
    n_strips = strips(R, int(qlens.max()) if B else 0)
    steps = total_steps // n_strips
    rows = torch.arange(1, n_strips * 32 * R + 1, device=dev)
    ok = (rows < W)[None, :] & (rows[None, :] <= qlens.long()[:, None])
    bv = torch.where(ok, best[:, 0, rows.clamp(max=W - 1)].long(), 0)
    keys = (bv << KEY_BITS) + (MAX_LEN - 1 - (rows - 1))
    key = keys.max(dim=1).values
    score = key >> KEY_BITS
    i = torch.where(score > 0, MAX_LEN - (key & (MAX_LEN - 1)), 0)
    j = best[:, 1, :].gather(1, i.clamp(max=W - 1)[:, None])[:, 0].long() - i
    flat = words.reshape(B, -1)

    def read(i, j):
        u = (i - 1).clamp(min=0)
        p, u = u // (32 * R), u % (32 * R)
        k, t = u // R, u % R
        s = p * steps + (j - 1 + k).clamp(0, steps - 1)
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
    qlens/rlens int32[B] (<= m_pad, <= n_pad, <= MAX_LEN); mat int32[24,
    24].
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
    one_strip = strips(R, m_pad) == 1
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
        # direction words that do not fit in shared memory, and a long
        # query's strips and borders: global scratch
        use = use_smem.value if one_strip else 0
        scratch = None if use else torch.empty(
            B * lib.kt_sw_align_pair_bytes(R, m_pad, n_pad),
            dtype=torch.uint8, device=dev)
        rc = lib.kt_sw_align(
            qcodes.data_ptr(), rcodes.data_ptr(), qlens.data_ptr(),
            rlens.data_ptr(), mat.data_ptr(), B, m_pad, n_pad, d_pad, R,
            int(gap_open), int(gap_extend), use, warps.value,
            None if scratch is None else scratch.data_ptr(),
            score.data_ptr(), q_ops.data_ptr(), r_ops.data_ptr(),
            n_ops.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "sw_align")
    launches["sw_align"] += 1
    return score, q_ops, r_ops, n_ops


def padded(m_max: int, n_max: int):
    """(m_pad, n_pad) of a batch whose longest query and reference have
    m_max and n_max residues: W = m_pad + 1 a multiple of 128, n_pad a
    multiple of 128 (swalign_pallas.py:277-285)."""
    m_max, n_max = max(2, m_max), max(2, n_max)
    return ((m_max + 1 + 127) // 128) * 128 - 1, ((n_max + 127) // 128) * 128


def pad_pairs(qs: List[np.ndarray], rs: List[np.ndarray]):
    """Host batch of LETTER_INDEX arrays in the JAX package's padded layout
    (padded).  Returns numpy (qcodes uint8[B, m_pad], rcodes uint8[B,
    n_pad], qlens int32[B], rlens int32[B])."""
    m_pad, n_pad = padded(max(len(q) for q in qs), max(len(r) for r in rs))
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


def launch_cells(qlens: np.ndarray, rlens: np.ndarray, m_pad: int):
    """(cells, padded cells) of one launch: the pairs' qlen * rlen, and the
    rows the kernel sweeps for them, 32R every strip a pair's query takes,
    times its rlen."""
    R = rows_per_lane(m_pad)
    q, r = qlens.astype(np.int64), rlens.astype(np.int64)
    n_strips = np.maximum(1, -(-q // (32 * R)))
    return int(q @ r), int(32 * R * (n_strips @ r))


def sw_batch_dispatch(qs: List[np.ndarray], rs: List[np.ndarray],
                      scores: MatrixScores, device, counts: dict = None):
    """Check the pair lengths on the host, upload the batch and enqueue the
    alignment on `device`; sw_batch_resolve finishes.  Nothing here waits
    for the card.  Returns the device-side op arrays.

    The launch runs in a `kaamer.align.kernel:<cells>:<padded>:<bytes>`
    span: its real and padded cells (launch_cells) and the bytes of its
    inputs and outputs, in the name, which the saved trace keeps whole.
    counts, where given, gains the launch (aln_launches, aln_cells,
    aln_padded_cells)."""
    qcodes, rcodes, qlens, rlens = pad_pairs(qs, rs)
    B, m_pad = qcodes.shape
    n_pad = rcodes.shape[1]
    if B:
        check_lengths(int(qlens.max()), int(rlens.max()), m_pad, n_pad)
    cells, padded = launch_cells(qlens, rlens, m_pad)
    if counts is not None:
        counts["aln_launches"] += 1
        counts["aln_cells"] += cells
        counts["aln_padded_cells"] += padded
    # codes and lengths in, the matrix, scores, paths and their lengths out
    nbytes = (B * (m_pad + n_pad + 16) + 4 * N_LETTERS * N_LETTERS
              + 4 * B * _d_pad(m_pad, n_pad))
    qcodes, rcodes, qlens, rlens = upload_all((qcodes, rcodes, qlens, rlens),
                                              device)
    mat = _device_matrix(scores, device)
    with span(f"kaamer.align.kernel:{cells}:{padded}:{nbytes}"):
        return sw_align(qcodes, rcodes, qlens, rlens, mat, scores.gap_open,
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
