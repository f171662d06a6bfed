"""Phase-2 chunks as replayed CUDA graphs.

A phase-2 chunk's device work depends only on its shape, and none of it
reads back to the host (the certificate is read later, in
prefetch_batch).  So the engine captures each recurring chunk shape once
and replays it, one graph launch in place of the chunk's ~190 kernel
launches, each of which costs the host tens of microseconds.

A chunk's key is (kind, G_pad, L, cap_s, cap_t, k, pack_w_bits, k_cold):
kind is "cold", "hot" or "legacy", and G_pad (pad_width) is the chunk's
rows rounded up to a power of two of at least 16, at most the planned
width.  The pad rows read a null row (slice start miss_start, every
count and cumsum 0, wstart 1: no postings) and their outputs are
dropped.  Every operation of phase 2 works row by row, so a real row's
outputs are those of the unpadded chunk, byte for byte.

- A key's first chunk runs eagerly, as without graphs: that also loads
  the lazily loaded kernels and warms cuBLAS and the allocator.  The
  second captures the graph and replays it; later ones replay.
- A capture that fails leaves its key eager for the rest of the process,
  with one line on stderr; no request fails for it.
- At most MAX_KEYS keys are captured; beyond that, chunks run eagerly.
- A replay runs the rle_sorted launches recorded at its capture, and
  counts them (ops/count.count_replayed); the capture itself counts none.
- A hot or legacy chunk is two graphs around the hot-set GEMM: A runs
  everything up to the GEMM's operand W (the expansion, hot_weights),
  the GEMM runs eagerly through hotset.hot_matmul (so that a wrapper of
  that module attribute sees every call) straight into B's static input,
  and B runs the rest (the merge, the ranking, the certificate).  The
  chunk's function is the engine's own _phase2_*_impl: its `gemm`
  argument ends A and begins B at capture.  One GEMM output buffer, as
  large as the largest hot chunk's, serves every hot key.
- All graphs share one memory pool, so a replay may overwrite another
  graph's outputs: run() copies the outputs out right after the replay.
  One lock holds the gather into the static inputs, the replays and the
  copy, since the request threads share the stream and the buffers.
- Capture runs on a side stream in thread-local mode: another request
  thread keeps launching and reading on the current stream meanwhile.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.count import count_replayed, thread_recorded

MAX_KEYS = 512


def pad_width(G: int, n: int) -> int:
    """The rows a chunk of n rows, planned at width G, replays at: the
    next power of two of n, at least 16, at most G (the planner's widths
    step by 4x, so padding to G could quadruple a tail chunk's work)."""
    return min(G, max(16, 1 << (n - 1).bit_length()))


def graph_key(kind: str, G: int, n: int, L: int, cap_s: int, cap_t: int,
              k: int, pack_w_bits: int = 0, k_cold: int = 0) -> tuple:
    """The key of a chunk of n rows planned at width G."""
    return (kind, pad_width(G, n), L, cap_s, cap_t, k, pack_w_bits, k_cold)


class Gemm(NamedTuple):
    """The hot-set GEMM of a hot or legacy chunk: run(W, out) writes
    W @ M into out, a [G_pad, P] tensor of dtype."""
    run: Callable
    dtype: torch.dtype
    P: int


class _Captured:
    """A captured key: its graphs (A only, or A and B around the GEMM),
    static inputs, the GEMM's operand and output, the outputs, and the
    rle_sorted launches recorded in it."""

    __slots__ = ("graphs", "inputs", "W", "gemm_out", "outs", "rle")


class ChunkGraphs:
    """The captured phase-2 chunks of one engine, on its CUDA device."""

    def __init__(self, device, gemm_bytes: int):
        """gemm_bytes: the largest hot chunk's GEMM output."""
        self.device = torch.device(device)
        self.gemm_bytes = gemm_bytes
        self.lock = threading.Lock()
        self._seen = set()
        self._chunks = {}      # key -> _Captured, or None: runs eagerly
        self._inputs = {}      # (G_pad, L) -> int64[6, G_pad, L]
        self._gemm_buf = None  # uint8[gemm_bytes]
        self._pool = self._side = None

    def run(self, key: tuple, n: int, fill: Callable, phase2: Callable,
            stats: dict, gemm: Optional[Gemm] = None):
        """The chunk's outputs, each cut to its n real rows, from a replay
        of the key's graph; None where the chunk runs eagerly.

        fill(x) gathers the chunk's six phase-1 tables (offs, cum_s,
        wstart, whot, cum_t, lens_l, pad rows included) into the static
        int64[6, G_pad, L] x; phase2(x, gemm) returns the outputs of the
        chunk's function on x, whose hot-set product goes through
        gemm(W, M, L) where that is given.  Counts stats["graph_keys"]
        (first sightings), ["graph_captures"] and ["graph_replays"]."""
        with self.lock:
            ch = self._chunks.get(key, False)
            if ch is False:
                if key not in self._seen:
                    self._seen.add(key)
                    stats["graph_keys"] += 1
                    return None
                if len(self._chunks) >= MAX_KEYS:
                    return None
                ch = self._chunks[key] = self._capture(key, phase2, gemm)
                if ch is None:
                    return None
                stats["graph_captures"] += 1
            elif ch is None:
                return None
            fill(ch.inputs)
            ch.graphs[0].replay()
            if gemm is not None:
                gemm.run(ch.W, ch.gemm_out)
                ch.graphs[1].replay()
            count_replayed(ch.rle)
            stats["graph_replays"] += 1
            return tuple(t[:n].clone() for t in ch.outs)

    def _gemm_out(self, G: int, gemm: Gemm) -> Optional[torch.Tensor]:
        """The shared GEMM output buffer as [G, P] of gemm.dtype (None
        when it does not fit)."""
        nbytes = G * gemm.P * gemm.dtype.itemsize
        if nbytes > self.gemm_bytes:
            return None
        if self._gemm_buf is None:
            self._gemm_buf = torch.empty(self.gemm_bytes, dtype=torch.uint8,
                                         device=self.device)
        return self._gemm_buf[:nbytes].view(gemm.dtype).view(G, gemm.P)

    def _capture(self, key: tuple, phase2: Callable,
                 gemm: Optional[Gemm]) -> Optional[_Captured]:
        """Capture the key's graphs into the shared pool on the side
        stream; None, with one line on stderr, where that fails."""
        G, L = key[1], key[2]
        ch = _Captured()
        ch.W = ch.gemm_out = None
        if gemm is not None:
            ch.gemm_out = self._gemm_out(G, gemm)
            if ch.gemm_out is None:
                return None
        x = self._inputs.get((G, L))
        if x is None:
            x = self._inputs[(G, L)] = torch.empty(
                (6, G, L), dtype=torch.int64, device=self.device)
        ch.inputs = x
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        ch.graphs = [torch.cuda.CUDAGraph()
                     for _ in range(1 if gemm is None else 2)]
        capturing = []

        def begin(g):
            g.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            capturing.append(g)

        def end():
            capturing.pop().capture_end()

        def split(W, M, L):
            # the chunk's GEMM: end A at its operand, begin B at its output
            ch.W = W
            end()
            begin(ch.graphs[1])
            return ch.gemm_out

        n0 = thread_recorded()
        try:
            with torch.cuda.stream(self._side):
                begin(ch.graphs[0])
                ch.outs = phase2(x, None if gemm is None else split)
                end()
        except Exception as e:  # noqa: BLE001 -- any failure means eager
            while capturing:
                try:
                    end()
                except Exception:  # noqa: BLE001 -- already failing
                    pass
            msg = (str(e).splitlines() or [""])[0]
            print(f"chunk graphs: capture of {key} failed, the key runs "
                  f"eagerly: {type(e).__name__}: {msg}", file=sys.stderr,
                  flush=True)
            return None
        ch.rle = thread_recorded() - n0
        return ch
