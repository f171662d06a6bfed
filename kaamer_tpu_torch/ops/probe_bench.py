"""The probe microbenchmarks' device kernels (csrc/probe_bench.cu), each
with a plain torch version of the same signature.

  row_dma_probe   row copies device memory -> shared memory, `depth`
                  cp.async stages in flight per warp over the whole card
                  (the Pallas DMA probes P1-P3 and P6)
  smem_dyngather  repeated data-dependent gathers from an on-chip table
                  (the Pallas VMEM gathers P4 and P5)

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  Both return int32[1] holding the 32 result bits (the scripts'
int32 or uint32 checksum).  torch on the CPU has no uint32 << or wrapping
*, so the plain versions compute in int64 masked to 32 bits.
"""

from __future__ import annotations

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
    uint32 words), T a power of two.  Returns int32[1], the 32 bits of the
    sum mod 2^32."""
    dev = x.device
    _check("x", x, torch.int32, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    if x.shape != (T, 128) or idx.shape != (T, 128) or T & (T - 1):
        raise ValueError(f"want x, idx [{T}, 128] with T a power of two, got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}")
    if dev.type == "cpu":
        return smem_dyngather_plain(x, idx, T, inner)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if T * 4 > 227 * 1024:
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
