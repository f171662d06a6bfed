"""Profiling harness of the torch port (kaamer_tpu/bench/harness.py;
reference cmd/kaamer-bench + monitor.go).

Wraps makedb / opendb / search / scaling workloads with wall-clock timing,
an interval-sampling memory monitor writing monitor.out JSON lines with a
final MaxRSS summary (monitor.go:45-115 equivalent), optional cProfile
output (pprof equivalent), and optional torch.profiler traces of the
search path (CPU and CUDA activities, a Chrome trace) where the JAX
package writes a jax.profiler trace.  The engine runs on -device (default
cuda); a missing card is an error unless -device cpu is given.

Usage:
  python -m kaamer_tpu_torch.bench.harness -func makedb -i in.fasta -f fasta -d db/
  python -m kaamer_tpu_torch.bench.harness -func opendb -d db/
  python -m kaamer_tpu_torch.bench.harness -func search -d db/ -i queries.fasta \\
      [-trace DIR]
  python -m kaamer_tpu_torch.bench.harness -func scaling -d db/
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import sys
import threading
import time

import torch

# the Chrome trace -trace DIR writes
TRACE_FILE = "search.pt.trace.json"
# scaling's largest mesh on the CPU, where every shard shares the host's
# cores (the JAX harness takes XLA's virtual CPU devices instead)
CPU_SHARDS = 4


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class MemoryMonitor:
    """Interval RSS sampler -> monitor.out (one JSON object per sample),
    reporting MaxRSS at stop (monitor.go semantics)."""

    def __init__(self, path: str = "monitor.out", interval: float = 1.0):
        self.path = path
        self.interval = interval
        self.max_rss = 0
        self._stop = threading.Event()
        self._thread = None
        self._f = None

    def __enter__(self):
        self._f = open(self.path, "w")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        t0 = time.time()
        while not self._stop.is_set():
            rss = _rss_bytes()
            self.max_rss = max(self.max_rss, rss)
            self._f.write(json.dumps({"t": round(time.time() - t0, 2),
                                      "rss_bytes": rss}) + "\n")
            self._f.flush()
            self._stop.wait(self.interval)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._f.write(json.dumps({"MaxRSS_bytes": self.max_rss}) + "\n")
        self._f.close()
        print(f"MaxRSS: {self.max_rss / 1e9:.3f} GB (monitor: {self.path})")


def _device(args) -> torch.device:
    """The engine's device; a CUDA device without a card raises."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"-device {args.device}: CUDA is not available "
                           "(pass -device cpu to run on the CPU)")
    return device


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_makedb(args) -> None:
    from ..index.build import build_db

    build_db(args.d, args.i, args.f or "fasta", no_index=args.noindex,
             progress=True)


def run_opendb(args) -> None:
    from ..index.artifact import load_db
    from ..search.engine import SearchEngine

    device = _device(args)
    t0 = time.perf_counter()
    art = load_db(args.d)
    engine = SearchEngine(art, device)
    # force device residency
    _synchronize(engine.device)
    print(f"opendb: {time.perf_counter() - t0:.2f}s, "
          f"{art.num_proteins} proteins, "
          f"{len(engine.postings_np)} postings")


def run_search(args) -> None:
    from ..index.artifact import load_db
    from ..search.engine import SearchEngine
    from ..search.options import PROTEIN, SearchOptions
    from ..search.pipeline import run_search as _run

    device = _device(args)
    art = load_db(args.d)
    engine = SearchEngine(art, device)
    opts = SearchOptions(File=args.i, SequenceType=PROTEIN, MaxResults=10)

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    t0 = time.perf_counter()
    n_bytes = 0
    n_rows = 0
    for chunk in _run(engine, opts):
        n_bytes += len(chunk)
        n_rows += chunk.count(b"\n")
    _synchronize(device)
    dt = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, TRACE_FILE)
        prof.export_chrome_trace(path)
        print(f"device trace written to {path}")
    print(f"search: {dt:.2f}s, {n_rows} result rows, {n_bytes} bytes")


def run_scaling(args) -> None:
    """Scaling-efficiency measurement: time the sharded search step over
    meshes of 1, 2, 4, ... shards -- of every card for -device cuda, of
    the CPU repeated up to CPU_SHARDS times (the counterpart of XLA's
    virtual CPU devices) for -device cpu."""
    import numpy as np

    from ..index.artifact import load_db
    from ..parallel.dist import Mesh, ShardedSearchEngine

    device = _device(args)
    art = load_db(args.d)
    rng = np.random.default_rng(11)
    n_q = 256
    queries = []
    for _ in range(n_q):
        row = int(rng.integers(0, art.num_proteins))
        queries.append(art.sequence(row)[:80])
    sizes = [len(q) - 6 for q in queries]

    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device] * CPU_SHARDS
    platform = device.type
    # CPU "devices" share the same host cores: every shard probes the full
    # dp-local batch, so total work grows with n_shards while the cores
    # don't -- the CPU run validates the sharded path + overhead, not
    # speedup.  Cards parallelize that work.
    note = ("cpu shards share host cores; validates sharded path, "
            "not speedup" if platform == "cpu" else "")
    base = None
    n = 1
    while n <= len(devices):
        eng = ShardedSearchEngine(art, Mesh([devices[:n]]))
        eng.count_batch(queries, sizes, k=10)  # warm
        _synchronize(device)
        t0 = time.perf_counter()
        for _ in range(2):
            eng.count_batch(queries, sizes, k=10)
        _synchronize(device)
        qps = 2 * n_q / (time.perf_counter() - t0)
        if base is None:
            base = qps
        rec = {
            "n_shards": n,
            "platform": platform,
            "queries_per_s": round(qps, 1),
            "speedup": round(qps / base, 2),
            "efficiency": round(qps / base / n, 2),
        }
        if note:
            rec["note"] = note
        print(json.dumps(rec))
        n *= 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kaamer-bench")
    p.add_argument("-func", required=True,
                   choices=["makedb", "opendb", "search", "scaling"])
    p.add_argument("-i", default="", help="input file")
    p.add_argument("-f", default="fasta", help="input format")
    p.add_argument("-d", required=True, help="database path")
    p.add_argument("-noindex", action="store_true")
    p.add_argument("-profile", action="store_true", help="write cProfile stats")
    p.add_argument("-trace", default="",
                   help="torch.profiler trace directory (search)")
    p.add_argument("-monitor", default="monitor.out", help="memory monitor output")
    p.add_argument("-interval", type=float, default=1.0, help="sampler interval (s)")
    p.add_argument("-device", default="cuda",
                   help="torch device of the engine (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    fn = {"makedb": run_makedb, "opendb": run_opendb, "search": run_search,
          "scaling": run_scaling}[args.func]

    t0 = time.perf_counter()
    with MemoryMonitor(args.monitor, args.interval):
        if args.profile:
            prof_path = f"{args.func}.prof"
            cProfile.runctx("fn(args)", globals(), locals(), prof_path)
            print(f"cProfile stats written to {prof_path}")
        else:
            fn(args)
    print(f"total wall time: {time.perf_counter() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
