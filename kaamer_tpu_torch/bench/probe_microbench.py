"""Device microbenchmarks of the hash-probe design study, on torch
(scripts/pallas_dma_probe.py and scripts/probe_microbench.py).

    python -m kaamer_tpu_torch.bench.probe_microbench \
        [all|v1|v2|v3|v4|e1|e1b|e2|e3|e4|e5|e6] [--device cuda|cpu]

One function per experiment of the two scripts, under the scripts' names;
each takes an explicit device, prints the script's line and returns
(checksum, best-of-3 seconds of one call, fetch of the checksum
included).  The checksum has the script's type: int32 for v1-v4, uint32
for the rest.

  v1-v3, e4  row copies device memory -> shared memory through a ring of
             `depth` copies in flight (ops/probe_bench.row_dma_probe, the
             CUDA port of the Pallas DMA probes P1-P3, P6)
  v4, e3     repeated gathers from an on-chip table
             (ops/probe_bench.smem_dyngather, the port of P4, P5)
  e1, e1b    row gathers vs row width and table size (plain torch)
  e5         windowed gathers (plain torch)
  e6         gathers vs index locality (plain torch)
  e2         sorts: flat, key + payload, batched rows (plain torch)

The XLA experiments (e1, e1b, e2, e5, e6) are plain torch, as they were
jnp in the scripts.  Their uint32 arithmetic runs in int64 masked to 32
bits (torch on the CPU has no uint32 << or wrapping *).  A device that is
not there is an error: there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import probe_bench as pb

MASK = 0xFFFFFFFF
W = 8            # pallas_dma_probe.py: 32 B rows
N_ROWS = 1 << 19
N = 1 << 19      # probe_microbench.py: gathered rows per iteration
ITERS = 16
LCG_A = 1664525
LCG_C = 1013904223


def timed(fn, *args, reps: int = 3):
    """Best-of-reps wall time of fn(*args) plus the fetch of its result to
    the host, after two warm calls (the scripts' timed).  Returns (host
    result, seconds)."""
    fn(*args).cpu()
    fn(*args).cpu()
    best = out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args).cpu()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def _i32(out) -> int:
    return int(out.reshape(-1)[0])


def _u32(out) -> int:
    return int(out.reshape(-1)[0]) & MASK


def _table(n_rows: int, width: int, device) -> torch.Tensor:
    """arange(n_rows * width) rows (the scripts' uint32 tables, whose
    values fit int32)."""
    return torch.arange(n_rows * width, dtype=torch.int32,
                        device=device).reshape(n_rows, width)


def _hash_idx(n: int, mod: int, device) -> torch.Tensor:
    """j * 2654435761 mod `mod`, j < n, as int32."""
    idx = (np.arange(n, dtype=np.int64) * 2654435761) % mod
    return torch.from_numpy(idx.astype(np.int32)).to(device)


# --------------------------------------------------------------------------
# scripts/pallas_dma_probe.py
# --------------------------------------------------------------------------


def v1_case(device):
    """P1's kernel, plain version and arguments: row 7 of the table."""
    idx = torch.full((1,), 7, dtype=torch.int32, device=device)
    return (pb.row_dma_probe, pb.row_dma_probe_plain,
            (_table(N_ROWS, W, device), idx, 1, 1, False, False))


def v2_case(device, n_dmas: int = 4096, depth: int = 8):
    return (pb.row_dma_probe, pb.row_dma_probe_plain,
            (_table(N_ROWS, W, device), _hash_idx(n_dmas, N_ROWS, device),
             n_dmas, depth, False, False))


def v3_case(device, n_dmas: int = 4096, depth: int = 8):
    return (pb.row_dma_probe, pb.row_dma_probe_plain,
            (_table(N_ROWS, W, device), _hash_idx(n_dmas, N_ROWS, device),
             n_dmas, depth, True, False))


def v4_case(device, T: int = 8192, inner: int = 32):
    idx = _hash_idx(T * 128, T, device).reshape(T, 128)
    return (pb.smem_dyngather, pb.smem_dyngather_plain,
            (_table(T, 128, device), idx, T, inner))


def v1_static_row_dma(device):
    """P1: one copy of the static row 7; checksum table[7, 0]."""
    kernel, _, args = v1_case(device)
    out, dt = timed(kernel, *args)
    print(f"v1 static-row DMA: OK {dt*1e3:.3f} ms", flush=True)
    return _i32(out), dt


def v2_dyn_row_dma(device, n_dmas: int = 4096, depth: int = 8):
    """P2: n_dmas dynamic-row copies, `depth` in flight, indices read from
    device memory; checksum the int32 sum of word 0."""
    kernel, _, args = v2_case(device, n_dmas, depth)
    out, dt = timed(kernel, *args)
    print(f"v2 dyn-row DMA depth={depth}: OK {dt*1e3:.3f} ms "
          f"{n_dmas/dt/1e6:.2f}M rows/s", flush=True)
    return _i32(out), dt


def v3_prefetch_dma(device, n_dmas: int = 4096, depth: int = 8):
    """P3: as v2, with the indices staged into shared memory first (the
    TPU's scalar prefetch)."""
    kernel, _, args = v3_case(device, n_dmas, depth)
    out, dt = timed(kernel, *args)
    print(f"v3 prefetch DMA depth={depth}: OK {dt*1e3:.3f} ms "
          f"{n_dmas/dt/1e6:.2f}M rows/s", flush=True)
    return _i32(out), dt


def v4_vmem_dyngather(device, T: int = 8192, inner: int = 32):
    """P4: `inner` rounds of on-chip gathers x[idx & (T-1), c] over a
    [T, 128] table; checksum the int32 sum."""
    kernel, _, args = v4_case(device, T, inner)
    out, dt = timed(kernel, *args)
    rate = T * 128 * inner / dt
    print(f"v4 VMEM dyngather [T={T},128] x{inner}: OK {dt*1e3:.3f} ms "
          f"{rate/1e6:.1f}M elems/s", flush=True)
    return _i32(out), dt


# --------------------------------------------------------------------------
# scripts/probe_microbench.py
# --------------------------------------------------------------------------


def _lcg_start(n: int, device) -> torch.Tensor:
    """arange(n) * 2654435761 mod 2^32 (the scripts' idx0), int64."""
    return (torch.arange(n, dtype=torch.int64, device=device)
            * 2654435761) & MASK


def gather_bench(device, n_buckets: int, width: int):
    """E1: ITERS rounds of N random row gathers from [n_buckets, width]."""
    mask = n_buckets - 1
    table = _table(n_buckets, width, device)

    def run(idx0):
        s = torch.zeros((), dtype=torch.int64, device=device)
        idx = idx0
        for i in range(ITERS):
            rows = table.index_select(0, idx & mask)
            s = (s + rows[:, 0].long().sum()) & MASK
            idx = (idx * LCG_A + LCG_C + i) & MASK
        return s

    out, dt = timed(run, _lcg_start(N, device))
    rate = N * ITERS / dt
    print(f"E1 gather  buckets=2^{n_buckets.bit_length()-1} width={width:3d}u32"
          f" ({width*4:4d}B rows): {dt*1e3:8.2f} ms/call "
          f"{rate/1e6:7.1f}M rows/s", flush=True)
    return _u32(out), dt


def windowed_gather_bench(device, n_buckets: int, width: int, window: int):
    """E5: one `window`-row slice gathered per probe (the adjacent-window
    cuckoo layout); starts are masked into range, so the script's CLIP
    never applies."""
    mask = n_buckets - 1 - (window - 1)
    table = _table(n_buckets, width, device)
    offs = torch.arange(window, device=device)

    def run(idx0):
        s = torch.zeros((), dtype=torch.int64, device=device)
        idx = idx0
        for i in range(ITERS):
            rows = table[(idx & mask)[:, None] + offs]       # [N, window, w]
            s = (s + rows[:, 0, 0].long().sum()) & MASK
            idx = (idx * LCG_A + LCG_C + i) & MASK
        return s

    out, dt = timed(run, _lcg_start(N, device))
    rate = N * ITERS / dt
    print(f"E5 wgather buckets=2^{n_buckets.bit_length()-1} width={width:3d}"
          f" window={window} ({window*width*4:4d}B slices): {dt*1e3:8.2f} "
          f"ms/call {rate/1e6:7.1f}M slices/s", flush=True)
    return _u32(out), dt


def sorted_gather_bench(device, n_buckets: int, width: int, kind: str):
    """E6: gather cost vs index locality: 'sorted', 'runs' of 16
    consecutive rows, or 'random'."""
    table = _table(n_buckets, width, device)
    if kind == "sorted":
        idx = np.sort((np.arange(N, dtype=np.int64) * 2654435761
                       % n_buckets).astype(np.int32))
    elif kind == "runs":
        base = (np.arange(N // 16, dtype=np.int64) * 2654435761
                % n_buckets).astype(np.int32)
        idx = (base[:, None] + np.arange(16, dtype=np.int32)[None, :]
               ).reshape(-1) % n_buckets
    else:
        idx = (np.arange(N, dtype=np.int64) * 2654435761 % n_buckets).astype(
            np.int32)
    idx = torch.from_numpy(idx.astype(np.int64)).to(device)

    def run(idx):
        s = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(ITERS):
            rows = table.index_select(0, (idx + 12345 * i) & (n_buckets - 1))
            s = (s + rows[:, 0].long().sum()) & MASK
        return s

    out, dt = timed(run, idx)
    rate = N * ITERS / dt
    print(f"E6 gather  {kind:6s} width={width:3d}: {dt*1e3:8.2f} ms/call "
          f"{rate/1e6:7.1f}M rows/s", flush=True)
    return _u32(out), dt


def sort_bench(device, kind: str):
    """E2: 4 rounds of a sort of N uint32 keys: 'flat', 'pair' (key +
    payload) or 'rows' ([2048, 256] row-wise)."""

    def run(x0):
        s = torch.zeros((), dtype=torch.int64, device=device)
        x = x0
        for i in range(4):
            if kind == "flat":
                y = torch.sort(x).values
                s = s + y[0] + y[-1]
            elif kind == "pair":
                payload = x ^ 0xDEADBEEF
                yk, order = torch.sort(x, stable=True)
                s = s + yk[0] + payload[order[-1]]
            else:
                y = torch.sort(x, dim=1).values
                s = s + y[0, 0] + y[-1, -1]
            s = s & MASK
            x = (x * LCG_A + LCG_C + i) & MASK
        return s

    x0 = _lcg_start(N, device)
    out, dt = timed(run, x0 if kind != "rows" else x0.reshape(2048, 256))
    print(f"E2 sort    {kind:5s} n={N}: {dt/4*1e3:8.2f} ms/sort", flush=True)
    return _u32(out), dt


def e4_case(device, n_dmas: int = 4096, depth: int = 8):
    n_buckets = 1 << 19
    return (pb.row_dma_probe, pb.row_dma_probe_plain,
            (_table(n_buckets, 16, device),
             _hash_idx(n_dmas, n_buckets, device), n_dmas, depth, True, True))


def pallas_dyngather_bench(device, T: int, inner_iters: int = 32):
    """P5 (E3): the on-chip gather of v4, checksum as uint32."""
    kernel, _, args = v4_case(device, T, inner_iters)
    out, dt = timed(kernel, *args)
    rate = T * 128 * inner_iters / dt
    print(f"E3 dyngather [T={T:6d},128] x{inner_iters}: {dt*1e3:8.2f} ms/call "
          f"{rate/1e6:7.1f}M elems/s", flush=True)
    return _u32(out), dt


def pallas_dma_bench(device, n_dmas: int = 4096, depth: int = 8):
    """P6 (E4): per-row copy rate of 64 B rows with `depth` copies in
    flight; checksum word 0 of the row last copied into slot 0."""
    kernel, _, args = e4_case(device, n_dmas, depth)
    out, dt = timed(kernel, *args)
    rate = n_dmas / dt
    print(f"E4 dma     depth={depth}: {dt*1e3:8.2f} ms/{n_dmas} DMAs "
          f"{rate/1e6:7.2f}M rows/s", flush=True)
    return _u32(out), dt


# The Pallas probes P1-P6 at the scripts' own configurations: (probe,
# entry point, its kernel/plain/arguments, keyword arguments).
PALLAS_CONFIGS = (
    ("P1", v1_static_row_dma, v1_case, {}),
    ("P2", v2_dyn_row_dma, v2_case, {}),
    ("P3", v3_prefetch_dma, v3_case, {}),
    ("P4", v4_vmem_dyngather, v4_case, {}),
    *(("P5", pallas_dyngather_bench, v4_case, {"T": T})
      for T in (512, 4096, 8192)),
    *(("P6", pallas_dma_bench, e4_case, {"depth": d}) for d in (1, 8, 16)),
)


def run(which: str, device) -> None:
    """The experiments of `which`, in the scripts' order."""
    for name, fn in (("v1", v1_static_row_dma), ("v2", v2_dyn_row_dma),
                     ("v3", v3_prefetch_dma), ("v4", v4_vmem_dyngather)):
        if which in ("all", name):
            fn(device)
    if which in ("all", "e1"):
        for width in (2, 8, 16, 24, 32):
            gather_bench(device, 1 << 19, width)
        for nb in (1 << 14, 1 << 16, 1 << 22):
            gather_bench(device, nb, 16)
    if which == "e1b":
        for width in (1, 4):
            gather_bench(device, 1 << 19, width)
        gather_bench(device, 1 << 22, 4)
        gather_bench(device, 1 << 22, 2)
        gather_bench(device, 1 << 24, 2)
    if which in ("all", "e5"):
        windowed_gather_bench(device, 1 << 19, 6, 2)
        windowed_gather_bench(device, 1 << 19, 6, 1)
        windowed_gather_bench(device, 1 << 19, 12, 1)
        windowed_gather_bench(device, 1 << 22, 6, 2)
    if which in ("all", "e6"):
        for kind in ("random", "runs", "sorted"):
            sorted_gather_bench(device, 1 << 19, 6, kind)
        for kind in ("random", "runs"):
            sorted_gather_bench(device, 1 << 22, 1, kind)
    if which in ("all", "e2"):
        for kind in ("flat", "pair", "rows"):
            sort_bench(device, kind)
    if which in ("all", "e3"):
        for T in (512, 4096, 8192):
            pallas_dyngather_bench(device, T)
    if which in ("all", "e4"):
        for depth in (1, 8, 16):
            pallas_dma_bench(device, depth=depth)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all", "v1", "v2", "v3", "v4", "e1", "e1b",
                             "e2", "e3", "e4", "e5", "e6"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("probe_microbench: CUDA is not available", file=sys.stderr)
            return 1
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print(f"device: {device} (plain torch versions)", flush=True)
    run(args.which, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
