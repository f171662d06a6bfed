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
"""

from __future__ import annotations

import argparse
import cProfile
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proteins", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--requests", default="R1,R2",
                    help="comma-separated subset of R1-R5")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

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
