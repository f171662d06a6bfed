"""The probe microbenchmarks' device kernels (csrc/probe_bench.cu), each
with a plain torch version of the same signature.

  row_dma_probe   row copies device memory -> shared memory, `depth`
                  cp.async stages in flight per warp over the whole card
                  (the Pallas DMA probes P1-P3 and P6)
  smem_dyngather  repeated data-dependent gathers from an on-chip table
                  (the Pallas VMEM gathers P4 and P5)

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  Both return int32[1] holding the 32 result bits (the scripts'
int32 or uint32 checksum).  smem_dyngather's shared-memory layout is
mirrored here in numpy (dyngather_slot, dyngather_warp_rows) with its
bank-conflict model (dyngather_wavefronts), so the CPU tests check the
layout.  torch on the CPU has no uint32 << or wrapping *, so the plain
versions compute in int64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

MASK = 0xFFFFFFFF

# kernel launches by wrapper (not counting plain-version calls)
launches = {"row_dma_probe": 0, "smem_dyngather": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a value mod 2^32 -> int32[1] with the same bits."""
    v = v.reshape(1) & MASK
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _check(name: str, t: torch.Tensor, dtype, ndim: int, dev) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != dev:
        raise ValueError(f"{name}: want {dtype} {ndim}-d on {dev}, got "
                         f"{t.dtype} {t.dim()}-d on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def row_dma_probe_plain(table, idx, n: int, depth: int, stage_idx: bool,
                        last_slot0: bool) -> torch.Tensor:
    """The copy ring's result without the ring: the wrapping sum of word 0
    of rows idx[:n], or (last_slot0) word 0 of row idx[j0], j0 the last
    multiple of depth below n.  stage_idx changes where the kernel reads
    its indices, not the result."""
    if last_slot0:
        return _bits(table[idx[((n - 1) // depth) * depth].long(), 0].long())
    return _bits((table[idx[:n].long(), 0].long() & MASK).sum())


def row_dma_probe(table, idx, n: int, depth: int, stage_idx: bool = False,
                  last_slot0: bool = False) -> torch.Tensor:
    """Copy rows table[idx[j]] for j < n into shared memory, each warp of
    the kernel keeping `depth` stages of copies in flight (the TPU's ring
    of `depth` slots).  table int32[rows, W] (uint32 words, W * 4 a
    multiple of 16 bytes), idx int32[>= n] row ids in range.  Returns
    int32[1]: the wrapping sum of the rows' word 0, or with last_slot0
    word 0 of row idx[j0], the last copy into slot 0 of the TPU's ring.
    Raises RuntimeError where one warp's ring does not fit in a block's
    shared memory (rows above 512 B, when the ring's stages, at most
    `depth`, times the row bytes come near 227 KB)."""
    dev = table.device
    _check("table", table, torch.int32, 2, dev)
    _check("idx", idx, torch.int32, 1, dev)
    if not 1 <= n <= idx.shape[0] or not 1 <= depth <= 64:
        raise ValueError(f"need 1 <= n <= {idx.shape[0]} and 1 <= depth "
                         f"<= 64, got n={n} depth={depth}")
    if dev.type == "cpu":
        return row_dma_probe_plain(table, idx, n, depth, stage_idx,
                                   last_slot0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if (table.shape[1] * 4) % 16 or table.data_ptr() % 16:
        raise ValueError("rows must be 16-byte multiples at 16-byte "
                         "aligned addresses (16-byte cp.async chunks)")
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        rc = lib.kt_row_dma_probe(
            table.data_ptr(), table.shape[1], idx.data_ptr(), n, depth,
            int(stage_idx), int(last_slot0), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "row_dma_probe")
    launches["row_dma_probe"] += 1
    return out


# smem_dyngather's layout (csrc/probe_bench.cu): one block of DG_THREADS
# threads a column, idx walked in chunks of DG_CHUNK rows
DG_THREADS = 1024
DG_CHUNK = 8192


def dyngather_slot(a):
    """Shared-memory slot of word a of a column (the kernel's dg_slot):
    every bit above the 5 bank bits folded into them by XOR.  A bijection
    on [0, T) for every power of two T <= 2^15.  Takes an int or an
    integer array."""
    return a ^ (((a >> 5) ^ (a >> 10)) & 31)


def dyngather_warp_rows(T: int) -> np.ndarray:
    """The rows each lane of each warp gathers for, int64[warp steps, 32],
    -1 where a lane is idle (warps with no row are left out): thread t of
    a block takes rows lo + t, lo + t + DG_THREADS, ... of each chunk
    [lo, lo + min(T, DG_CHUNK)), so lane l of warp w at step k holds row
    lo + k * DG_THREADS + 32 * w + l.  Every warp's lanes hold 32
    consecutive rows of the block's column (as in the first port, 256
    threads a block)."""
    chunk = min(T, DG_CHUNK)
    within = np.arange(-(-chunk // 32) * 32, dtype=np.int64).reshape(-1, 32)
    within = np.where(within < chunk, within, -1)
    return np.concatenate([np.where(within >= 0, within + lo, -1)
                           for lo in range(0, T, chunk)])


def dyngather_wavefronts(idx: np.ndarray, T: int, inner: int,
                         swizzle: bool = True) -> float:
    """Modelled shared-memory wavefronts of one warp gather of
    smem_dyngather on idx (int[T, 128]) over `inner` rounds, the mean over
    columns, warps and rounds: a warp's load takes one wavefront per
    distinct word in its busiest bank (slot mod 32).  swizzle=False
    models the first port, which stored word a at slot a."""
    rows = dyngather_warp_rows(T)
    live = rows >= 0
    ids = np.asarray(idx, np.int64).T[:, np.maximum(rows, 0)] & 0xFFFFFFFF
    total = 0.0
    for i in range(inner):
        a = ids & (T - 1)
        slot = np.where(live, dyngather_slot(a) if swizzle else a, -1)
        slot = np.sort(slot.reshape(-1, 32), axis=1)
        first = np.ones(slot.shape, bool)
        first[:, 1:] = slot[:, 1:] != slot[:, :-1]
        first &= slot >= 0
        warp = np.broadcast_to(np.arange(slot.shape[0])[:, None], slot.shape)
        per_bank = np.bincount((warp * 32 + (slot & 31))[first],
                               minlength=slot.shape[0] * 32)
        total += per_bank.reshape(-1, 32).max(axis=1).mean()
        ids = (ids * 1664525 + 7 + i) & 0xFFFFFFFF
    return total / inner if inner else 0.0


def smem_dyngather_plain(x, idx, T: int, inner: int) -> torch.Tensor:
    """sum over i < inner of x[idx_i & (T-1), c] over every (r, c), with
    idx_{i+1} = idx_i * 1664525 + 7 + i, all mod 2^32."""
    xv = x.long() & MASK
    iv = idx.long() & MASK
    s = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(inner):
        s = (s + xv.gather(0, iv & (T - 1)).sum()) & MASK
        iv = (iv * 1664525 + 7 + i) & MASK
    return _bits(s)


def smem_dyngather(x, idx, T: int, inner: int) -> torch.Tensor:
    """Repeated on-chip gathers along rows: x, idx int32[T, 128] (x holds
    uint32 words), T a power of two, inner >= 0 rounds.  Returns int32[1],
    the 32 bits of the sum mod 2^32."""
    dev = x.device
    _check("x", x, torch.int32, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    if x.shape != (T, 128) or idx.shape != (T, 128) or T & (T - 1):
        raise ValueError(f"want x, idx [{T}, 128] with T a power of two, got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}")
    if inner < 0:
        raise ValueError(f"want inner >= 0, got {inner}")
    if dev.type == "cpu":
        return smem_dyngather_plain(x, idx, T, inner)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if T > 32768:
        raise ValueError(f"a column of T={T} words exceeds shared memory")
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        rc = lib.kt_smem_dyngather(
            x.data_ptr(), idx.data_ptr(), T, inner, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "smem_dyngather")
    launches["smem_dyngather"] += 1
    return out
