"""The serving requests of chip_smoke.py (R1-R5) on one card: their
definitions, the HTTP helpers that serve them, and an entry point that
times them warm and profiles them.

  R1  2048 protein queries, TSV defaults
  R2  256 protein queries, align=true
  R3  64 protein queries, JSON with positions
  R4  8,192 FASTQ reads, TSV defaults (the lean translated path)
  R5  64 contigs of 4 genes each, JSON with positions and align=true

    python -m kaamer_tpu_torch.bench.serving [--proteins N] [--reps 3]
        [--requests R1,R2] [--profile]

Serves the seed-77 skewed database with hot sets on: each request once
untimed, then `reps` times in turns, each time over HTTP (the client in
this process) and then directly through run_search in this thread (the
"direct" walls: no server, form or client).  --profile then runs each
request once more through run_search under torch.profiler (device time
by kernel, the device's busy share of the wall) and once under cProfile
(host time by function).  Prints the card (nvidia-smi name and power
limit) and, as its last line, one JSON object {"card": ..., "R1": [wall
s, ...], "R1 direct": [...], ...}.  A missing card is an error.  To
compare two trees (a change and its parent) on one card, run it in each
within one machine, in turns: A, B, B, A (KAAMER_BENCH_CACHE shares the
database).

    python -m kaamer_tpu_torch.bench.serving --first none|warmup --db PATH

is one side of chip_smoke.py's warmup phase, meant for a fresh process:
it loads the database at PATH onto the card and serves R1, R3 and R4
twice each.  With `none` the first R1 and a second one are served in
this thread under torch.profiler and cProfile, with the client in a
child process (Python 3.12's cProfile sees every thread), and the first
R1's wall over the second's is split into CUDA API time by call,
cuBLAS's first use, Python and C functions (first_request_split); with
`warmup`, engine.warmup() runs first, timed, with its dispatches and
the device memory it leaves.  The last line is one JSON object with the
walls, the figures and each body's sha256.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import hashlib
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np


def fasta(prefix: str, queries) -> str:
    return "".join(f">{prefix}{i} smoke query\n{q}\n"
                   for i, q in enumerate(queries))


def post(url: str, fields: dict):
    """POST a form; returns (status, body, wall seconds)."""
    data = urllib.parse.urlencode(fields).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=600) as resp:
        body = resp.read()
        status = resp.status
    return status, body, time.perf_counter() - t0


class Served:
    """The port's HTTP server for one engine, on a free local port, for the
    duration of a with block (which yields the search URL prefix: append
    protein, nucleotide or fastq)."""

    def __init__(self, engine):
        from ..server.app import make_server

        tmp = tempfile.mkdtemp(prefix="kaamer_serve_")
        self.httpd = make_server(engine, 0, tmp, host="127.0.0.1")

    def __enter__(self):
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return (f"http://127.0.0.1:{self.httpd.server_address[1]}"
                "/api/search/")

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def requests(queries, reads: str, contigs: str):
    """R1-R5: (name, route, form fields, what one counts)."""
    json_pos = {"output-format": "json", "positions": "true"}
    return (
        ("R1", "protein", {"sequence": fasta("r_", queries)}, "queries"),
        ("R2", "protein", {"sequence": fasta("r_", queries[:256]),
                           "align": "true"}, "queries"),
        ("R3", "protein", {"sequence": fasta("r_", queries[:64]), **json_pos},
         "queries"),
        ("R4", "fastq", {"sequence": reads}, "reads"),
        ("R5", "nucleotide", {"sequence": contigs, "align": "true",
                              **json_pos}, "contigs"),
    )


def smoke_requests(art, rng):
    """R1-R5 from the database and rng: 2048 make_queries queries, then
    8,192 reads, then 64 contigs."""
    from . import data

    queries = data.make_queries(art, rng, 2048)
    return queries, requests(queries, data.make_reads_fastq(art, rng, 8192),
                             data.make_contigs_fasta(art, rng, 64))


def _options(route: str, fields: dict, tmp: str):
    """The server's options for a request's form."""
    from ..search.options import NUCLEOTIDE, PROTEIN, READS
    from ..server.app import _default_options, parse_search_options

    opts = _default_options({"protein": PROTEIN, "nucleotide": NUCLEOTIDE,
                             "fastq": READS}[route])
    err = parse_search_options(opts, {"type": "string", **fields}, {}, tmp)
    if err:
        raise ValueError(err)
    return opts


def profile_request(engine, name: str, route: str, fields: dict,
                    card: str) -> None:
    """One run_search of the request under torch.profiler, then one under
    cProfile: the device's busy time and top kernels, the host's top
    functions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..search.pipeline import run_search

    opts = _options(route, fields, tempfile.mkdtemp(prefix="kaamer_prof_"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b"".join(run_search(engine, opts))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e6
    print(f"{name} profile: wall {wall} s under torch.profiler, device busy "
          f"{busy} s ({busy / wall} of the wall), {sum(e.count for e in dev)}"
          f" device activities [{card}]")
    for e in sorted(dev, key=lambda e: -e.device_time_total)[:12]:
        print(f"  {e.device_time_total / 1e3:12.3f} ms {e.count:7d}x "
              f"{e.key[:100]}")
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    b"".join(run_search(engine, opts))
    torch.cuda.synchronize()
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(18)
    print(f"{name} host profile (cProfile, by own time; wall "
          f"{time.perf_counter() - t0} s):")
    print(out.getvalue().strip())


@contextlib.contextmanager
def counting_calls(obj, names):
    """Count the calls of obj's methods `names` made within the block
    (through instance attributes that wrap them); yields {name: calls}."""
    counts = dict.fromkeys(names, 0)

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    for name in names:
        setattr(obj, name, counted(name, getattr(obj, name)))
    try:
        yield counts
    finally:
        for name in names:
            del obj.__dict__[name]


def _api_bucket(name: str) -> str:
    """The first-request split's bucket of a CUDA runtime or driver call."""
    if name.startswith(("cudaHostAlloc", "cudaMallocHost", "cuMemHostAlloc")):
        return "cudaHostAlloc"
    if name.startswith(("cudaMalloc", "cuMemAlloc", "cuMemCreate")):
        return "cudaMalloc"
    if name.startswith(("cuModuleLoad", "cuLibraryLoad", "cuModuleGetFunction",
                        "cuLibraryGetKernel", "cudaGetFuncBySymbol")):
        return "module loads"
    if "Launch" in name:
        return "kernel launches"
    if "Memcpy" in name or "Synchronize" in name:
        return "copies and waits"
    return "other API"


class _Profiled:
    """One POST handled in this thread under torch.profiler and cProfile:
    the handler's wall inside both, CUDA API seconds and calls by bucket,
    the aten::mm calls as (host seconds outside CUDA API calls, CUDA API
    seconds inside), and cProfile's own seconds of each function."""

    def __init__(self, wall: float, events: list, stats: dict):
        self.wall = wall
        api = [e for e in events if e.get("ph") == "X"
               and ("runtime" in e.get("cat", "") or
                    "driver" in e.get("cat", ""))]
        self.api = {}
        for e in api:
            n, t = self.api.get(_api_bucket(e["name"]), (0, 0.0))
            self.api[_api_bucket(e["name"])] = (n + 1, t + e["dur"] / 1e6)
        self.mm = []
        for e in sorted((e for e in events if e.get("cat") == "cpu_op"
                         and e.get("name") == "aten::mm"),
                        key=lambda e: e["ts"]):
            inside = sum(a["dur"] for a in api
                         if e["ts"] <= a["ts"] <= e["ts"] + e["dur"]) / 1e6
            self.mm.append((e["dur"] / 1e6 - inside, inside))
        # (file, line, name) -> own seconds; file "~" marks C functions
        self.own = {k: v[2] for k, v in stats.items()}


def _profiled_post(httpd, url: str, fields: dict, tmp: str) -> tuple:
    """POST the form to httpd, a one-thread server, from a client process,
    and handle it in this thread under torch.profiler (CPU ops and CUDA
    activity) and cProfile.  Returns (_Profiled, response body)."""
    from torch.profiler import ProfilerActivity, profile

    handler = httpd.RequestHandlerClass
    orig = handler.do_POST
    out = {}

    def do_post(self):
        pr = cProfile.Profile()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pr.enable()
            t0 = time.perf_counter()
            try:
                orig(self)
            finally:
                out["wall"] = time.perf_counter() - t0
                pr.disable()
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            out["events"] = json.load(f)["traceEvents"]
        os.remove(trace)
        out["stats"] = pstats.Stats(pr).stats

    form, body = os.path.join(tmp, "form.json"), os.path.join(tmp, "body")
    with open(form, "w") as f:
        json.dump({"type": "string", **fields}, f)
    client = subprocess.Popen([sys.executable, "-c", (
        "import json, sys, urllib.parse, urllib.request\n"
        "form = json.load(open(sys.argv[2]))\n"
        "data = urllib.parse.urlencode(form).encode()\n"
        "r = urllib.request.urlopen(urllib.request.Request(sys.argv[1], "
        "data=data), timeout=600)\n"
        "open(sys.argv[3], 'wb').write(r.read())\n"), url, form, body])
    handler.do_POST = do_post
    try:
        httpd.handle_request()
    finally:
        handler.do_POST = orig
    if client.wait(timeout=600) != 0:
        raise RuntimeError(f"the client process exited {client.returncode}")
    with open(body, "rb") as f:
        return _Profiled(out["wall"], out["events"], out["stats"]), f.read()


def first_request_split(first: _Profiled, warm: _Profiled) -> dict:
    """The first request's wall over a warm one's, split into disjoint
    parts: CUDA API seconds by bucket (first minus warm), cuBLAS's first
    use (the first aten::mm's host time outside CUDA API calls, over a
    warm one's median), cProfile's own time of Python functions and of
    the other C functions (first minus warm; CUDA API calls and cuBLAS
    happen inside C functions, so those are subtracted), and the
    remainder."""
    split = {"first s": first.wall, "warm s": warm.wall,
             "excess s": first.wall - warm.wall}
    api_total = 0.0
    for b in ("cudaMalloc", "cudaHostAlloc", "module loads",
              "kernel launches", "copies and waits", "other API"):
        (n1, t1), (n2, t2) = (p.api.get(b, (0, 0.0)) for p in (first, warm))
        split[f"{b} s"] = t1 - t2
        split[f"{b} calls"] = [n1, n2]
        api_total += t1 - t2
    cublas = 0.0
    if first.mm and warm.mm:
        base = float(np.median([h for h, _ in warm.mm]))
        cublas = first.mm[0][0] - base
        split["first aten::mm [host s, CUDA API s]"] = list(first.mm[0])
        split["warm aten::mm host s (median)"] = base
    split["cuBLAS first use s"] = cublas

    def own(p, c_functions):
        return sum(t for k, t in p.own.items() if (k[0] == "~") == c_functions)

    py = own(first, False) - own(warm, False)
    c_other = own(first, True) - own(warm, True) - api_total - cublas
    split["Python functions s"] = py
    split["other C functions s"] = c_other
    split["remainder s"] = (split["excess s"] - api_total - cublas - py
                            - c_other)
    top = sorted(((t - warm.own.get(k, 0.0), k) for k, t in first.own.items()),
                 reverse=True)[:10]
    split["top functions (first - warm s)"] = [
        [f"{os.path.basename(k[0])}:{k[1]}:{k[2]}" if k[0] != "~" else k[2],
         d] for d, k in top]
    return split


def first_requests(db_path: str, warm: bool) -> dict:
    """One side of chip_smoke.py's warmup phase, for a fresh process: load
    the database onto the card, then R1, R3 and R4 twice each over HTTP.
    warm=False: the first R1 and a second one are handled in this thread
    under both profilers and split (first_request_split), then the rest go
    through the threaded server.  warm=True: engine.warmup() first, timed,
    with its dispatches and the device memory it leaves.  Returns the
    walls, the figures and each body's sha256."""
    import torch
    from http.server import HTTPServer

    from ..index.artifact import load_db
    from ..search.engine import SearchEngine
    from ..server.app import make_handler, web_dirs

    if not torch.cuda.is_available():
        raise RuntimeError("first_requests needs a card")
    card = card_line()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    art = load_db(db_path)
    engine = SearchEngine(art, device)
    torch.cuda.synchronize(device)
    out = {"side": "warmup" if warm else "no warmup",
           "load s": time.perf_counter() - t0,
           "resident bytes": torch.cuda.memory_allocated(device)}
    reqs = [r for r in smoke_requests(art, np.random.default_rng(2026))[1]
            if r[0] in ("R1", "R3", "R4")]
    tmp = tempfile.mkdtemp(prefix="kaamer_first_")
    if warm:
        stats = dict(engine.stats)
        torch.cuda.reset_peak_memory_stats(device)
        with counting_calls(engine, ("dispatch_batch", "_dispatch_group",
                                     "_warm_p2")) as counts:
            t0 = time.perf_counter()
            engine.warmup()
            torch.cuda.synchronize(device)
            out["warmup s"] = time.perf_counter() - t0
        if engine.stats != stats:
            raise RuntimeError(f"warmup changed stats: {engine.stats}")
        out["warmup dispatches"] = counts
        out["reserved bytes"] = torch.cuda.memory_reserved(device)
        out["peak allocated bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"warmup: {out['warmup s']} s; phase 1: "
              f"{counts['dispatch_batch']} batches "
              f"({counts['_dispatch_group']} phase-2 chunks); phase 2: "
              f"{counts['_warm_p2']} zero-input dispatches; reserved "
              f"{out['reserved bytes']} bytes, peak allocated "
              f"{out['peak allocated bytes']} (resident "
              f"{out['resident bytes']}) [{card}]", flush=True)
    walls, sha = {}, {}

    def keep(name, body, wall):
        digest = hashlib.sha256(body).hexdigest()
        if sha.setdefault(name, digest) != digest:
            raise RuntimeError(f"{name}: the second body differs")
        walls.setdefault(name, []).append(wall)

    if not warm:
        name, route, fields, _ = reqs[0]
        httpd = HTTPServer(("127.0.0.1", 0),
                           make_handler(engine, tmp, web_dirs()))
        url = (f"http://127.0.0.1:{httpd.server_address[1]}/api/search/"
               f"{route}")
        runs = [_profiled_post(httpd, url, fields, tmp) for _ in range(2)]
        httpd.server_close()
        for prof, body in runs:
            keep(name, body, prof.wall)
        out["split"] = first_request_split(runs[0][0], runs[1][0])
        sp = out["split"]
        print(f"first R1 split (no warmup; handler walls under torch.profiler"
              f" and cProfile): " + "; ".join(
                  f"{k} {v}" for k, v in sp.items()
                  if not k.startswith("top")) + f" [{card}]", flush=True)
        print(f"first R1 own time by function, first - warm (cProfile): "
              f"{sp['top functions (first - warm s)']}", flush=True)
    with Served(engine) as url:
        for name, route, fields, _ in reqs:
            for _ in range(2 if name not in walls else 1):
                status, body, wall = post(url + route,
                                          {"type": "string", **fields})
                if status != 200:
                    raise RuntimeError(f"{name}: HTTP {status}")
                keep(name, body, wall)
    out.update(walls=walls, sha256=sha)
    print(f"{out['side']}: " + "; ".join(
        f"{n} first {w[0]} s, warm {w[-1]} s" for n, w in walls.items())
        + (" (R1's two walls are the profiled handler walls; a third, "
           f"unprofiled over HTTP: {walls['R1'][-1]} s)" if not warm else "")
        + f" [{card}]", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proteins", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--requests", default="R1,R2",
                    help="comma-separated subset of R1-R5")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--first", choices=("none", "warmup"),
                    help="serve R1, R3, R4 from a fresh process with no "
                    "warmup (the first R1 split) or after engine.warmup()")
    ap.add_argument("--db", help="the database --first serves")
    args = ap.parse_args()
    if args.first:
        print(json.dumps(first_requests(args.db, args.first == "warmup")))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("serving: CUDA is not available", file=sys.stderr)
        return 1
    from ..search.engine import SearchEngine
    from . import data

    card = card_line()
    print(card)
    path = os.path.join(data.CACHE_ROOT, f"skew_{args.proteins}")
    art = data.ensure_db(path, data.build_skewed_db, args.proteins, 77)
    engine = SearchEngine(art, torch.device("cuda", 0))
    wanted = args.requests.split(",")
    reqs = [r for r in smoke_requests(art, np.random.default_rng(2026))[1]
            if r[0] in wanted]
    from ..search.pipeline import run_search

    tmp = tempfile.mkdtemp(prefix="kaamer_direct_")
    opts = {name: _options(route, fields, tmp)
            for name, route, fields, _ in reqs}
    walls = {f"{name}{how}": [] for name, *_ in reqs
             for how in ("", " direct")}
    with Served(engine) as url:
        bodies = {}
        for rep in range(args.reps + 1):
            for name, route, fields, _ in reqs:
                status, body, wall = post(url + route,
                                          {"type": "string", **fields})
                t0 = time.perf_counter()
                direct = b"".join(run_search(engine, opts[name]))
                torch.cuda.synchronize()
                t_direct = time.perf_counter() - t0
                if (status != 200 or direct != body
                        or bodies.setdefault(name, body) != body):
                    raise RuntimeError(f"{name}: HTTP {status}, or bytes "
                                       "other than the first pass's")
                if rep:
                    walls[name].append(wall)
                    walls[f"{name} direct"].append(t_direct)
    if args.profile:
        for name, route, fields, _ in reqs:
            profile_request(engine, name, route, fields, card)
    print(json.dumps({"card": card, **walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
