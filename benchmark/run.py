"""The benchmark of kaamer_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m benchmark.run ...`) from the root of a checkout on a
machine with the cards the cell asks for.  What the harness does, in
order:

1. opens the cell's configuration's database, made on the first run in
   the checkout (database.py), and starts the mix's clients as processes
   of their own (client.py), which make every request they may send;
2. loads the database onto the card with the program's
   server.app.load_engine, warms the engine over the traffic mix's own
   batch sizes, lengths and positions flags, and starts the program's
   HTTP server on a free port in this process; each client sends it one
   request that is not measured;
3. keeps the window: it opens when set-up ends and closes when the last
   request sent before --seconds had passed is answered; with --trace 1
   the profiler, on every thread, and the spans of spans.py record it;
4. frees the program, checks that no JAX module was loaded, and judges the
   judged records of every answer against the plain reference
   (judges/, reference/);
5. calls the reader of each of the cell's metrics (metrics/<name>.py):
   the end-to-end ones, or with --trace 1 the per-layer ones;
6. prints each number compared beside its limit as the last lines of
   standard error, and one JSON line as the last line of standard output.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if not __package__:  # run as a script: import the package from the root
    sys.path[0] = ROOT

from benchmark import database, host, registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kaamer_tpu")
# seconds the clients may take past the deadline to answer their last
# request and report
ANSWER_GRACE_S = 150


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_start() -> float:
    """The wall-clock time this process started (10 ms resolution), or
    when this module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


class Context:
    """What a metric reader reads: the cell, the window's requests as the
    clients recorded them, the window (time.monotonic()), the set-up
    walls, and in a traced run the spans and the reduced trace."""

    def __init__(self, cell, records, window, setup, spans=None,
                 trace=None):
        self.cell = cell
        self.records = records
        self.window = window
        self.setup = setup
        self.spans = spans
        self.trace = trace


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Clients:
    """The mix's client processes (client.py)."""

    def __init__(self, cell, db_path: str, seed: int):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs = []
        for c in range(int(cell.mix["loop"]["clients"])):
            arg = json.dumps({"mix": cell.mix, "db": db_path,
                              "seed": seed, "client": c})
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.client", arg], cwd=ROOT,
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True))
        self.outputs = [None] * len(self.procs)
        self.cpu_s = 0.0

    def _say(self, line: str) -> None:
        for p in self.procs:
            p.stdin.write(line + "\n")
            p.stdin.flush()

    def _heard(self, word: str) -> bool:
        return all(p.stdout.readline().strip() == word for p in self.procs)

    def ready(self, port: int) -> bool:
        """Each client made its requests, then sent its unmeasured one to
        the server."""
        if not self._heard("made"):
            return False
        self._say(f"serve {port}")
        return self._heard("ready")

    def go(self, deadline: float) -> None:
        self._say(f"go {deadline!r}")
        for p in self.procs:
            p.stdin.close()

    def collect(self, timeout: float):
        """Every client's records, or None if one failed or overran."""
        def read(i, p):
            self.outputs[i] = p.stdout.read()
        threads = [threading.Thread(target=read, args=(i, p), daemon=True)
                   for i, p in enumerate(self.procs)]
        for t in threads:
            t.start()
        end = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, end - time.monotonic()))
        if any(t.is_alive() for t in threads):
            return None
        records = []
        for p, out in zip(self.procs, self.outputs):
            if p.wait() != 0 or not out.strip():
                return None
            got = json.loads(out.strip().splitlines()[-1])
            records += [dict(r, client=got["client"]) for r in got["records"]]
            self.cpu_s += got["cpu_s"]
        return records

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
            if p.stdout:
                p.stdout.close()


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None, *, bench_path: str = "", traffic_dir: str = "",
         cache_root: str = "", device: str = "cuda", plant=None) -> int:
    """One run of one cell; the keyword arguments are for the tests (a
    benchmark file of their own, the CPU, a fault planted in the engine
    after warmup)."""
    t_start = process_start()
    args = parse(argv)
    cell = registry.cell(args.workload, bench_path, traffic_dir)

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2

    with contextlib.redirect_stdout(sys.stderr):
        db = database.ensure(cell.config, cache_root, log=log)
    clients = Clients(cell, db.path, args.seed)
    try:
        return serve(args, cell, db, clients, t_start, device, plant, torch)
    finally:
        clients.stop()


def serve(args, cell, db, clients, t_start, device, plant, torch) -> int:
    from kaamer_tpu_torch.ops import hotset
    from kaamer_tpu_torch.server import app

    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        engine = app.load_engine(db.artifact, device)
    load_s = time.time() - t0
    t0 = time.time()
    warm = cell.mix["warmup"]
    engine.warmup(batch_sizes=tuple(warm["batch_sizes"]),
                  lengths=tuple(warm["lengths"]),
                  positions=tuple(warm["positions"]))
    if device == "cuda":
        torch.cuda.synchronize()
    warmup_s = time.time() - t0
    if plant is not None:
        plant(engine)

    tmp = tempfile.mkdtemp(prefix="kaamer-bench-")
    httpd = app.make_server(engine, port=0, tmp_folder=tmp, host="127.0.0.1")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    prof = spans = trace = None
    try:
        if not clients.ready(httpd.server_address[1]):
            log("a client failed before the window")
            return 1
        if args.trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)

            from benchmark.spans import Spans
            from benchmark.tracefile import WINDOW, Trace

            log(f"card: {card_line()}")
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            prof = profile(activities=acts, experimental_config=(
                torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True)))
            prof.start()
            spans = Spans(app, hotset, engine, httpd.RequestHandlerClass)
        stats0 = dict(engine.stats)
        setup_s = time.time() - t_start
        t_open = time.monotonic()
        cpu0 = host.snapshot()
        with contextlib.ExitStack() as window:
            if prof is not None:
                window.enter_context(record_function(WINDOW))
            clients.go(t_open + args.seconds)
            records = clients.collect(args.seconds + ANSWER_GRACE_S)
        cpu1 = host.snapshot()
        if records is None:
            log("a client failed or overran in the window")
            return 1
        stats = {k: v - stats0.get(k, 0) for k, v in engine.stats.items()}
        if prof is not None:
            prof.stop()
            spans.remove()
            t0 = time.time()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            prof = None
            trace = Trace(path, spans.calls)
            os.remove(path)
            found = sum(ns > 0 for _, ns in trace.gemm_calls())
            log(f"trace: saved and read in {time.time() - t0:.1f} s; "
                f"{len(trace.spans)} spans; kernels found for {found} of "
                f"{len(spans.calls)} hot_matmul calls")
    finally:
        if prof is not None:
            prof.stop()
        httpd.shutdown()
        httpd.server_close()
        server.join()
        shutil.rmtree(tmp, ignore_errors=True)

    window = (t_open, max(r["t1"] for r in records))
    peak = int(torch.cuda.max_memory_allocated(0)) if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    del engine, httpd, server
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"modules loaded in this process that the benchmark forbids: "
            f"{loaded}")
        return 3

    log(f"window: {len(records)} requests in {window[1] - window[0]:.3f} s; "
        f"engine chunks {stats}")
    log(host.report(cpu0, cpu1, clients.cpu_s, window[1] - window[0]))
    for c in sorted({r["client"] for r in records}):
        mine = [r for r in records if r["client"] == c]
        log(f"client {c}: request walls " + " ".join(
            f"{r['t1'] - r['t0']:.2f}" for r in mine) + " s; last answered "
            f"at {mine[-1]['t1'] - t_open:.2f} s")
    t0 = time.time()
    judge = registry.judge(cell.mix["judge"]["name"])
    checks = judge.judge(db, cell.mix["route"],
                         judge.options(cell.mix.get("fields", {})), records,
                         log=log)
    log(f"judge: {time.time() - t0:.1f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    ctx = Context(cell, records, window,
                  {"setup_s": setup_s, "load_s": load_s,
                   "warmup_s": warmup_s},
                  trace.spans if trace else None, trace)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = registry.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": sum(1 for r in records if not r["ok"]),
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
