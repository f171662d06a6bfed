"""Search throughput on one card, on a SKEWED database: the port's twin of
the root bench.py.

    python -m kaamer_tpu_torch.bench.throughput [--device cuda|cpu]

Prints ONE JSON line on stdout (progress goes to stderr):

  {"metric": "...", "value": N, "unit": "queries/s", "vs_baseline": N,
   "extra": {...}}

Databases are domain-skewed synthetics (bench/data.py, bench.py's bytes):
proteins share power-law-popular "domains", so k-mer postings lists have
the heavy-tailed family structure real UniProt has.  A uniformly random
DB is also reported, for continuity: its postings lists are tiny.

Headline: protein queries/s against the 10k-protein skewed DB.  `extra`
carries {10k, 100k[, 1M]} x {plain, positions} figures, the FASTQ
pipeline rate, and the alignment rates through the hand-written
Smith-Waterman kernel (csrc/swalign.cu:sw_align_kernel): aligned pairs/s
of align_batch alone, and -aln queries/s end to end; align_on_device says
the pairs ran on the card's kernel (a CUDA device, and no pair went to
the host DP while timed), and sw_align_launches counts the kernel's
launches in each of the two.

vs_baseline divides the headline by a MEASURED CPU stand-in of the
reference's hot loop (bench/cpu_baseline.py, strictly faster than the
Go/Badger reference, so the multiplier is a lower bound), read from
$KAAMER_BENCH_CACHE/cpu_baseline.json only when that file was measured
on this host for the same headline DB; otherwise it is null: omitted,
not invented.

The environment is bench.py's: KAAMER_BENCH_SIZES (default
10000,100000,1000000), KAAMER_BENCH_BUDGET_S (an uncached 1M build is
skipped when less than 1500 s of this budget is left), KAAMER_BENCH_NO_ALIGN,
KAAMER_BENCH_DB (the random DB's path) and KAAMER_BENCH_CACHE.  The
options --db-proteins, --queries, --reads, --aln-queries and --pairs cut
the run (bench.py's numbers by default).  A failure raises: nothing here
turns a kernel's failure into a null.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import cpu_baseline, data
from .data import BATCH, DB_PROTEINS, QUERY_LEN, ensure_db, make_queries

# queries per skewed DB size (2048 for any other size)
N_QUERIES_BY_SIZE = {10_000: 8192, 100_000: 4096}
N_READS = 8_192
N_ALN_QUERIES = 1024
N_PAIRS = 256


def note(msg: str) -> None:
    """Progress on stderr; stdout stays one JSON line."""
    print(f"# {msg}", file=sys.stderr, flush=True)


def bench_protein(engine, queries, positions: bool, passes: int = 3) -> float:
    """Pipelined protein-search throughput: in each pass dispatch every
    batch, then schedule all, then prefetch all, then collect all (the
    card's queue stays full while the host finalizes earlier batches);
    best of `passes`, after two warm count_batch calls."""
    sizes = [len(q) - 6 for q in queries]
    n = len(queries)
    for _ in range(2):
        engine.count_batch(queries[:BATCH], sizes[:BATCH], k=10,
                           positions=positions)
    best = None
    for _ in range(passes):
        t0 = time.perf_counter()
        handles = [
            engine.dispatch_batch(queries[i:i + BATCH], sizes[i:i + BATCH],
                                  k=10, positions=positions)
            for i in range(0, n, BATCH)
        ]
        scheds = [engine.schedule_batch(h) for h in handles]
        scheds = [engine.prefetch_batch(s) for s in scheds]
        for s in scheds:
            engine.collect_batch(s)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return n / best


def bench_fastq(engine, art, rng, tmpdir: str, n_reads: int = N_READS) -> float:
    """Translated-reads throughput through the full FASTQ pipeline (read
    -> six-frame ORF scan -> batched device search -> filtering): reads/s,
    best of 2 passes after a warm run over the first 3072 reads."""
    from ..search.options import READS, SearchOptions
    from ..search.pipeline import run_search

    path = os.path.join(tmpdir, "bench_reads.fq")
    with open(path, "w") as f:
        f.write(data.make_reads_fastq(art, rng, n_reads))
    warm = os.path.join(tmpdir, "warm.fq")
    with open(warm, "w") as fw, open(path) as fr:
        fw.write("".join(line for _, line in zip(range(4 * 3072), fr)))
    for _ in run_search(engine, SearchOptions(File=warm, SequenceType=READS)):
        pass

    opts = SearchOptions(File=path, SequenceType=READS)
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        # the lean TSV path yields one bytes chunk per device batch, so
        # count result ROWS (newlines beyond the header), not chunks
        n_out = sum(chunk.count(b"\n") for chunk in
                    run_search(engine, opts)) - 1
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    if not n_out > n_reads // 2:
        raise RuntimeError(f"fastq bench found too few hits ({n_out})")
    return n_reads / best


def _sw_launches() -> int:
    from ..ops import swalign_cuda

    return swalign_cuda.launches["sw_align"]


def bench_align_e2e(engine, art, rng, tmpdir: str,
                    n_q: int = N_ALN_QUERIES):
    """End-to-end -aln protein serving: the full run_search stream with
    Align=True, so alignment pairs accumulate ACROSS queries and flush
    through the device kernel in real batches.  Returns (queries/s,
    sw_align launches over the warm and the two timed runs)."""
    from ..search.options import PROTEIN, SearchOptions
    from ..search.pipeline import run_search

    queries = make_queries(art, rng, n_queries=n_q)
    path = os.path.join(tmpdir, "bench_aln.fasta")
    with open(path, "w") as f:
        for i, q in enumerate(queries):
            f.write(f">q{i}\n{q}\n")
    opts = SearchOptions(File=path, SequenceType=PROTEIN, OutFormat="tsv",
                         Align=True, MaxResults=3)
    launches = _sw_launches()
    for _ in run_search(engine, opts):  # warm
        pass
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        n_out = sum(1 for _ in run_search(engine, opts))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    if not n_out > n_q // 2:
        raise RuntimeError(f"-aln bench streamed too few chunks ({n_out})")
    return n_q / best, _sw_launches() - launches


def bench_align(engine, art, rng, n_pairs: int = N_PAIRS):
    """Alignment throughput of align_batch on (query, top hit) pairs
    (the per-hit cost the reference pays on every -aln query,
    align.go:46-161).  Returns (aligned pairs/s, on_device, sw_align
    launches over the warm and the two timed calls): on_device is a CUDA
    device with no pair sent to the host DP in the timed calls."""
    from ..ops import swalign

    queries = make_queries(art, rng, n_queries=n_pairs)
    sizes = [len(q) - 6 for q in queries]
    qcs = engine.count_batch(queries, sizes, k=4)
    pairs = []
    for q, qc in zip(queries, qcs):
        if len(qc.hit_rows):
            pairs.append((q, art.sequence(int(qc.hit_rows[0]))))
    if not len(pairs) >= n_pairs // 2:
        raise RuntimeError(f"only {len(pairs)} of {n_pairs} queries hit")

    def align():
        return swalign.align_batch(pairs, art.stats, device=engine.device)

    launches = _sw_launches()
    res = align()  # warm
    if not res[0].Length > 0:
        raise RuntimeError("the first pair did not align")
    host_dp = swalign.HOST_DP_PAIRS
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        align()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    on_device = (engine.device.type == "cuda"
                 and swalign.HOST_DP_PAIRS == host_dp)
    return len(pairs) / best, on_device, _sw_launches() - launches


def run(device, db_proteins: int = DB_PROTEINS, n_queries: int = 0,
        n_reads: int = N_READS, n_aln_queries: int = N_ALN_QUERIES,
        n_pairs: int = N_PAIRS) -> dict:
    """The bench on `device`; returns the JSON record.  n_queries > 0
    replaces every DB's query count."""
    from ..search.engine import SearchEngine
    from .serving import card_line

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available (pass "
                           "--device cpu to run on the CPU)")
    sizes = [int(s) for s in os.environ.get(
        "KAAMER_BENCH_SIZES", "10000,100000,1000000").split(",") if s]
    budget_s = float(os.environ.get("KAAMER_BENCH_BUDGET_S", "3000"))
    no_align = bool(os.environ.get("KAAMER_BENCH_NO_ALIGN"))

    os.makedirs(data.CACHE_ROOT, exist_ok=True)
    per_db = {}
    skipped = []
    engine_head = art_head = None
    t_start = time.perf_counter()
    for n in sizes:
        path = os.path.join(data.CACHE_ROOT, f"skew_{n}")
        cached = os.path.exists(os.path.join(path, "meta.json"))
        elapsed = time.perf_counter() - t_start
        if n >= 1_000_000 and not cached and budget_s - elapsed < 1500:
            # an uncached 1M build is long; skip rather than lose the
            # whole bench to the wall clock (the next run finds it cached)
            skipped.append(n)
            note(f"db n={n}: SKIPPED (uncached build does not fit the "
                 f"remaining {budget_s - elapsed:.0f}s budget)")
            continue
        note(f"db n={n}: build/load")
        art = ensure_db(path, data.build_skewed_db, n)
        engine = SearchEngine(art, device)
        rng = np.random.default_rng(99)
        nq = n_queries or N_QUERIES_BY_SIZE.get(n, 2048)
        queries = make_queries(art, rng, n_queries=nq)
        note(f"db n={n}: protein qps ({nq} queries)")
        qps = bench_protein(engine, queries, positions=False,
                            passes=3 if n == db_proteins else 2)
        note(f"db n={n}: protein qps with positions")
        qps_pos = bench_protein(engine, queries, positions=True, passes=2)
        per_db[str(n)] = {
            "qps": qps,
            "qps_positions": qps_pos,
            "kmer_lookups_per_s": qps * (QUERY_LEN - 6),
            "n_queries": nq,
        }
        note(f"db n={n}: done {per_db[str(n)]} "
             f"t={time.perf_counter() - t_start:.0f}s")
        if n == db_proteins:
            engine_head, art_head = engine, art
        del engine  # free the card's memory before the next size
        gc.collect()

    # continuity figure: the uniformly random DB earlier rounds reported
    note("random-db continuity figure")
    rand_path = os.environ.get("KAAMER_BENCH_DB", os.path.join(
        data.CACHE_ROOT, f"random_{db_proteins}"))
    art_r = ensure_db(rand_path, data.build_synthetic_db, db_proteins)
    eng_r = SearchEngine(art_r, device)
    rng = np.random.default_rng(99)
    q_r = make_queries(art_r, rng, n_queries=n_queries or 8192)
    random_qps = bench_protein(eng_r, q_r, positions=False, passes=2)
    del eng_r
    gc.collect()

    fastq_rps = None
    launches = {"bench_align": None, "bench_align_e2e": None}
    aligned_pps = align_device = aln_qps = None
    if engine_head is None:
        # KAAMER_BENCH_SIZES without the headline DB: the FASTQ and -aln
        # sections need its engine
        no_align = True
    else:
        # one seed-7 generator through bench_fastq, bench_align and
        # bench_align_e2e, in bench.py's order: the same sequences
        note("fastq pipeline")
        rng = np.random.default_rng(7)
        with tempfile.TemporaryDirectory() as td:
            fastq_rps = bench_fastq(engine_head, art_head, rng, td, n_reads)
        note(f"fastq done t={time.perf_counter() - t_start:.0f}s")
    if not no_align:
        note("align_batch")
        aligned_pps, align_device, launches["bench_align"] = bench_align(
            engine_head, art_head, rng, n_pairs)
        note("end-to-end -aln serving")
        with tempfile.TemporaryDirectory() as td:
            aln_qps, launches["bench_align_e2e"] = bench_align_e2e(
                engine_head, art_head, rng, td, n_aln_queries)
        note(f"-aln done t={time.perf_counter() - t_start:.0f}s")

    head = per_db.get(str(db_proteins)) or next(iter(per_db.values()))
    cpu = cpu_baseline.load_for_this_host(db_proteins)
    vs = head["qps"] / cpu["queries_per_s"] if cpu else None
    vs_1m = None
    if (cpu and "1000000" in cpu.get("per_db", {})
            and "1000000" in per_db):
        vs_1m = (per_db["1000000"]["qps"]
                 / cpu["per_db"]["1000000"]["queries_per_s"])
    return {
        "metric": (
            f"protein queries/s (skewed {db_proteins}-protein DB, "
            f"{QUERY_LEN}aa queries, 1 card)"
        ),
        "value": head["qps"],
        "unit": "queries/s",
        "vs_baseline": vs,
        "extra": {
            "baseline_note": (
                "vs_baseline = headline / MEASURED in-memory C++ stand-in "
                "of the reference hot loop ("
                + (cpu["artifact"] if cpu else
                   "absent: no cpu_baseline.json measured on this host")
                + "; strictly faster than Go/Badger, so this is a lower "
                "bound)"
            ),
            "cpu_baseline_qps": cpu and cpu["queries_per_s"],
            "cpu_baseline_1m_qps": (
                cpu and cpu.get("per_db", {})
                .get("1000000", {}).get("queries_per_s")),
            "vs_baseline_1m": vs_1m,
            "skewed_db": per_db,
            "random_db_qps_10k": random_qps,
            "fastq_reads_per_s": fastq_rps,
            "aligned_pairs_per_s": aligned_pps,
            "align_on_device": align_device,
            "aln_queries_per_s": aln_qps,
            "sw_align_launches": launches,
            "skipped_dbs": skipped,
            "batch": BATCH,
            "query_len": QUERY_LEN,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
            "card": card_line() if device.type == "cuda" else None,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--db-proteins", type=int, default=DB_PROTEINS,
                    help="the headline skewed DB (also the random DB's size)")
    ap.add_argument("--queries", type=int, default=0,
                    help="queries per DB (default: 8192 at 10k, 4096 at "
                    "100k, else 2048; 8192 on the random DB)")
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--aln-queries", type=int, default=N_ALN_QUERIES)
    ap.add_argument("--pairs", type=int, default=N_PAIRS)
    args = ap.parse_args(argv)
    # anything the port prints while it builds or serves goes to stderr
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args.device, args.db_proteins, args.queries, args.reads,
                  args.aln_queries, args.pairs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
