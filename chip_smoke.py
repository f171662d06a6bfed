#!/usr/bin/env python3
"""GPU smoke run of the torch port (kaamer_tpu_torch) on one CUDA card.

Drives the port's two paths -- the probe microbenchmarks, and protein
search with and without -aln served over HTTP from a domain-skewed
database with hot sets on -- and checks them:

  1. builds the CUDA kernels (csrc/*.cu, one nvcc each, in parallel);
  2. probe phase: every Pallas probe configuration of the scripts (P1-P6)
     through the port's entry points (kaamer_tpu_torch.bench.
     probe_microbench) at the scripts' sizes, then each kernel
     (row_dma_probe, smem_dyngather) against its plain torch version on
     the same inputs, exactly, with both timed (the kernel's call time and
     its device time alone), and row_dma_probe at depths 1, 8 and 16 at
     4096 and 2^20 copies;
  3. kernel phase: sw_wavefront + sw_traceback on 512 random pairs
     (30-2048 residues) plus fixed cases, exactly equal to their plain
     torch versions on the card, scores equal to the host DP; times both
     at B=256, m ~ n ~ 250;
  4. builds (or reuses, .bench_cache/skew_N) the skewed database of
     bench.build_skewed_db and loads it onto the card with its hot sets;
  5. serves it with the port's server and POSTs R1 (2048 queries, TSV),
     R2 (256 queries, align=true) and R3 (64 queries, JSON + positions);
  6. checks sampled R1 counts against a numpy bincount reference and
     sampled R2 alignments against the plain SW versions on the card, and
     that each path launched every one of its kernels;
  7. serves R1 again from a cold engine (hot=False): the bytes must equal
     the hot engine's.

Prints the card (nvidia-smi name and power limit), per-request times, one
JSON line of kernel results, and as its last line
{"ok": true, "device": {...}}.  Any failure raises (exit code != 0).

    python3 chip_smoke.py [--proteins N]
"""

from __future__ import annotations

import argparse
import itertools
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
AA = "ACDEFGHIKLMNPQRSTVWY"
KMER_ALPHABET = "ACDEFGHIKLMNPQRSTUVWY"  # the 21-letter 7-mer alphabet
KERNELS = (
    ("sw_wavefront", "kaamer_tpu/ops/swalign_pallas.py:50"),
    ("sw_traceback", "kaamer_tpu/ops/swalign_pallas.py:166"),
)
# the Pallas probes: (probe, the pallas_call it replaces)
PROBES = (
    ("P1", "scripts/pallas_dma_probe.py:58"),
    ("P2", "scripts/pallas_dma_probe.py:99"),
    ("P3", "scripts/pallas_dma_probe.py:154"),
    ("P4", "scripts/pallas_dma_probe.py:185"),
    ("P5", "scripts/probe_microbench.py:217"),
    ("P6", "scripts/probe_microbench.py:282"),
)
# the configuration whose times head a probe's row (the others are listed
# under "configs"): the scripts' defaults, P4's table size for P5
PROBE_HEAD = {"P5": {"T": 8192}, "P6": {"depth": 8}}


def check(ok, what: str) -> None:
    """Fail the run (a raise, so the exit code is non-zero) unless ok."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def random_pairs(rng, n: int, lo: int, hi: int):
    """n pairs, half related (point mutations and a deleted stretch of the
    first sequence), half unrelated."""
    pairs = []
    for t in range(n):
        q = "".join(rng.choice(list(AA), size=int(rng.integers(lo, hi + 1))))
        if t % 2:
            r = "".join(rng.choice(list(AA),
                                   size=int(rng.integers(lo, hi + 1))))
        else:
            s = list(q)
            for _ in range(int(rng.integers(0, len(s) // 10 + 1))):
                s[int(rng.integers(0, len(s)))] = AA[int(rng.integers(0, 20))]
            if len(s) > 40:
                a = int(rng.integers(0, len(s) - 20))
                del s[a:a + int(rng.integers(1, 20))]
            r = "".join(s)
        pairs.append((q, r))
    return pairs


def fixed_pairs():
    """The cases of tests/test_swalign_pallas.py: related and unrelated
    short pairs, a perfect self alignment, and a pair with no positive
    cell."""
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(6):
        base = "".join(rng.choice(list(AA), size=int(rng.integers(30, 90))))
        m = list(base)
        for _ in range(int(rng.integers(0, 6))):
            m[int(rng.integers(0, len(m)))] = AA[int(rng.integers(0, 20))]
        if rng.random() < 0.5 and len(m) > 20:
            del m[5:9]
        pairs.append((base, "".join(m)))
    pairs.append(("".join(rng.choice(list(AA), size=40)),
                  "".join(rng.choice(list(AA), size=55))))
    seq = "MELPNIMHPVAKLSTALAAALMLSGCMPGEIRPTIGQQME"
    return pairs + [(seq, seq), ("WWWW", "PPPP")]


def pair_tensors(pairs, device):
    import torch

    from kaamer_tpu_torch.ops import swalign as sw
    from kaamer_tpu_torch.ops.swalign_cuda import pad_pairs

    arrays = pad_pairs([sw._codes(q) for q, _ in pairs],
                       [sw._codes(r) for _, r in pairs])
    scores = sw.get_matrix_scores("blosum62", 11, 1)
    mat = torch.from_numpy(scores.sub_matrix.astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays] + [mat.to(device)]


def _host_score(pair):
    from kaamer_tpu_torch.ops import swalign as sw

    scores = sw.get_matrix_scores("blosum62", 11, 1)
    return sw._smith_waterman(sw._codes(pair[0]), sw._codes(pair[1]),
                              scores.sub_matrix, 11, 1)[0]


def wavefront_err(dirs_a, best_a, dirs_b, best_b, qlens, rlens):
    """Max abs difference over the kernel's contract: dirs at valid cells,
    best at lanes 0..qlen (pairs compared in chunks to bound memory)."""
    import torch

    B, d_pad, W = dirs_a.shape
    dev = dirs_a.device
    d = torch.arange(d_pad, device=dev)[None, :, None]
    i = torch.arange(W, device=dev)[None, None, :]
    err = 0
    for b0 in range(0, B, 32):
        q = qlens[b0:b0 + 32].long()[:, None, None]
        r = rlens[b0:b0 + 32].long()[:, None, None]
        valid = (i >= 1) & (i <= q) & (d - i >= 1) & (d - i <= r)
        diff = (dirs_a[b0:b0 + 32].int() - dirs_b[b0:b0 + 32].int()).abs()
        err = max(err, int(torch.where(valid, diff, 0).max()))
    lanes = torch.arange(W, device=dev)[None, :] <= qlens.long()[:, None]
    diff = (best_a - best_b).abs().max(dim=1).values  # [B, W]
    return max(err, int(torch.where(lanes, diff, 0).max()))


def traceback_err(out_a, out_b):
    """Max abs difference of score, n_ops and the first n_ops ops."""
    import torch

    score_a, q_a, r_a, n_a = out_a
    score_b, q_b, r_b, n_b = out_b
    err = max(int((score_a - score_b).abs().max()),
              int((n_a - n_b).abs().max()))
    k = torch.arange(q_a.shape[1], device=q_a.device)[None, :]
    inside = k < n_a.long()[:, None]
    for x, y in ((q_a, q_b), (r_a, r_b)):
        err = max(err, int(torch.where(inside, (x.int() - y.int()).abs(),
                                       0).max()))
    return err


def median_ms(fn, reps: int) -> float:
    """Median over reps of one call's CUDA-event time, after a warm call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time (ms) of the CUDA kernels whose name starts with
    `kernel` over reps calls of fn, by torch.profiler: the kernel alone,
    without the host's launch cost.  The profiler may record fewer
    launches than were made (4 of 20 seen once on the H100); the mean is
    over those it recorded, and the run fails if it recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key.startswith(kernel)]
    check(bool(hits), f"profiler recorded no launch of {kernel} in {reps}")
    return (sum(e.device_time_total for e in hits)
            / sum(e.count for e in hits) / 1e3)


def kernel_phase(device, rng, n_pairs: int, max_len: int, workers: int):
    """Kernels vs plain versions on the card, scores vs the host DP, and
    the timing at B=256, m ~ n ~ 250.  Returns {name: result dict}."""
    import torch

    from kaamer_tpu_torch.ops import swalign_cuda as swc

    pairs = random_pairs(rng, n_pairs, 30, max_len) + fixed_pairs()
    qc, rc, ql, rl, mat = pair_tensors(pairs, device)
    dirs, best = swc.sw_wavefront(qc, rc, ql, rl, mat, 11, 1)
    out = swc.sw_traceback(dirs, best, ql)
    p_dirs, p_best = swc.sw_wavefront_plain(qc, rc, ql, rl, mat, 11, 1)
    p_out = swc.sw_traceback_plain(dirs, best, ql)
    torch.cuda.synchronize(device)
    res = {
        "sw_wavefront": {"max_abs_err": wavefront_err(
            dirs, best, p_dirs, p_best, ql, rl)},
        "sw_traceback": {"max_abs_err": traceback_err(out, p_out)},
    }
    del dirs, best, p_dirs, p_best
    with ProcessPoolExecutor(max_workers=workers, mp_context=
                             multiprocessing.get_context("spawn")) as pool:
        host = list(pool.map(_host_score, pairs, chunksize=8))
    scores = out[0].cpu().numpy()
    print(f"kernel phase: {len(pairs)} pairs (30-{max_len} residues), "
          f"wavefront max_abs_err {res['sw_wavefront']['max_abs_err']}, "
          f"traceback max_abs_err {res['sw_traceback']['max_abs_err']}, "
          f"scores == host DP: {bool((scores == host).all())}")
    for name, r in res.items():
        check(r["max_abs_err"] == 0, f"{name} disagrees with its plain version")
    check((scores == np.asarray(host)).all(), "kernel scores != host DP")
    check(scores[-2] > 0 and scores[-1] == 0,
          "self alignment must score, the no-hit pair must not")

    # timing at the -aln serving shape
    qc, rc, ql, rl, mat = pair_tensors(random_pairs(rng, 256, 240, 260),
                                       device)
    dirs, best = swc.sw_wavefront(qc, rc, ql, rl, mat, 11, 1)
    res["sw_wavefront"]["ms"] = median_ms(
        lambda: swc.sw_wavefront(qc, rc, ql, rl, mat, 11, 1), 20)
    res["sw_wavefront"]["plain_ms"] = median_ms(
        lambda: swc.sw_wavefront_plain(qc, rc, ql, rl, mat, 11, 1), 3)
    res["sw_traceback"]["ms"] = median_ms(
        lambda: swc.sw_traceback(dirs, best, ql), 20)
    res["sw_traceback"]["plain_ms"] = median_ms(
        lambda: swc.sw_traceback_plain(dirs, best, ql), 3)
    for name, r in res.items():
        print(f"{name} at B=256, m~n~250: kernel {r['ms']} ms, plain torch "
              f"{r['plain_ms']} ms (median, CUDA events)")
    return res


# ---------------------------------------------------------------------------
# probe phase
# ---------------------------------------------------------------------------


def time_probe(kernel, plain, args):
    """A probe kernel against its plain version on the same inputs,
    exactly, then timed: (kernel u32, plain u32, call ms by CUDA events,
    device ms by torch.profiler, plain ms by CUDA events)."""
    got = int(kernel(*args).item()) & 0xFFFFFFFF
    want = int(plain(*args).item()) & 0xFFFFFFFF
    ms = median_ms(lambda: kernel(*args), 20)
    dev_ms = device_ms(lambda: kernel(*args), f"{kernel.__name__}_kernel")
    plain_ms = median_ms(lambda: plain(*args), 5)
    return got, want, ms, dev_ms, plain_ms


def probe_phase(device, card: str):
    """P1-P6 through the entry points (the path; launches counted from 0),
    then each configuration's kernel against its plain version on the
    same inputs, exactly, with the kernel's call time (CUDA events), its
    device time alone (torch.profiler) and the plain version's time; then
    row_dma_probe's P2, P3 and P6 shapes at depths 1, 8 and 16, at 4096
    and at 2^20 copies, a measurement off the path.  Returns the kernels
    JSON rows of the probes."""
    from kaamer_tpu_torch.bench import probe_microbench as pmb
    from kaamer_tpu_torch.ops import probe_bench as pb

    runs = []
    pb.reset_launches()
    for label, entry, case, kw in pmb.PALLAS_CONFIGS:
        before = sum(pb.launches.values())
        checksum, secs = entry(device, **kw)
        runs.append((label, case, kw, checksum, secs,
                     sum(pb.launches.values()) - before))
    launches = dict(pb.launches)
    print(f"probe path kernel launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the probe path")

    rows = {}
    for label, case, kw, checksum, secs, n_launch in runs:
        kernel, plain, args = case(device, **kw)
        got, want, ms, dev_ms, plain_ms = time_probe(kernel, plain, args)
        err = abs(got - want)
        check(err == 0 and checksum & 0xFFFFFFFF == want,
              f"{label} {kw}: kernel {got}, entry point {checksum}, "
              f"plain {want}")
        work = (args[2] * 128 * args[3] if kernel is pb.smem_dyngather
                else args[2])
        unit = "elems" if kernel is pb.smem_dyngather else "rows"
        print(f"{label} {kernel.__name__} {kw or 'script defaults'}: "
              f"checksum {got} == plain; entry point best-of-3 {secs} s; "
              f"kernel call {ms} ms ({work / ms / 1e3} M {unit}/s), "
              f"device {dev_ms} ms, plain torch {plain_ms} ms (call: median "
              f"of CUDA events; device: torch.profiler mean) [{card}]")
        row = rows.setdefault(label, {
            "name": f"{label} {kernel.__name__}", "route": "cuda",
            "source": "kaamer_tpu_torch/csrc/probe_bench.cu",
            "launches": 0, "max_abs_err": 0, "configs": []})
        row["launches"] += n_launch
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["configs"].append({**kw, "launches": n_launch, "ms": ms,
                               "device_ms": dev_ms, "plain_ms": plain_ms})
        if kw == PROBE_HEAD.get(label, kw):
            row["ms"], row["plain_ms"] = ms, plain_ms

    # P2, P3 and P6 at depths 1, 8, 16, at the scripts' n and at 2^20
    # copies (the path's own configurations were timed above)
    for label, case in (("P2", pmb.v2_case), ("P3", pmb.v3_case),
                        ("P6", pmb.e4_case)):
        for n, depth in itertools.product((4096, 1 << 20), (1, 8, 16)):
            if n == 4096 and (label == "P6" or depth == 8):
                continue
            kernel, plain, args = case(device, n_dmas=n, depth=depth)
            got, want, ms, dev_ms, plain_ms = time_probe(kernel, plain, args)
            check(got == want, f"{label} n={n} depth={depth}: kernel {got}, "
                  f"plain {want}")
            print(f"{label} {kernel.__name__} n={n} depth={depth}: checksum "
                  f"{got} == plain; kernel call {ms} ms ({n / ms / 1e3} M "
                  f"rows/s), device {dev_ms} ms ({n / dev_ms / 1e3} M "
                  f"rows/s), plain torch "
                  f"{plain_ms} ms [{card}]")
            rows[label]["configs"].append({
                "n_dmas": n, "depth": depth, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms})
    out = []
    for label, replaces in PROBES:
        row = rows[label]
        check(row["launches"] > 0, f"{label} launched no kernel")
        out.append({**row, "replaces": replaces})
    return out


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------


def fasta(prefix: str, queries) -> str:
    return "".join(f">{prefix}{i} smoke query\n{q}\n"
                   for i, q in enumerate(queries))


def post(url: str, fields: dict):
    data = urllib.parse.urlencode(fields).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=600) as resp:
        body = resp.read()
        status = resp.status
    return status, body, time.perf_counter() - t0


def host_kmers(seq: str) -> np.ndarray:
    """7-mer codes of a sequence (the reference's EncodeKmer layout:
    three 9-bit residue pairs, then one 5-bit residue), in numpy."""
    idx = np.full(256, -1, np.int64)
    for n, c in enumerate(KMER_ALPHABET):
        idx[ord(c)] = n
    c = idx[np.frombuffer(seq.encode(), np.uint8)]
    n = len(c) - 6

    def pair(a, b):
        return np.where((a >= 0) & (b >= 0), 22 + a * 21 + b, 0)

    return ((pair(c[0:n], c[1:n + 1]) << 23) | (pair(c[2:n + 2], c[3:n + 3]) << 14)
            | (pair(c[4:n + 4], c[5:n + 5]) << 5) | np.maximum(c[6:n + 6], 0))


def reference_topk(art, seq: str, k: int):
    """Top-k (rows, counts) of one query by numpy: probe the cuckoo table
    on the host, count every k-mer position's postings with np.bincount
    (each distinct slice once, weighted by its position count), rank by
    (count desc, row asc)."""
    from kaamer_tpu_torch.ops.probe import HASH_MULT, HASH_MULT2

    q = host_kmers(seq).astype(np.uint64)
    table = np.asarray(art.hash_table)
    start = np.zeros(q.shape, np.int64)
    length = np.zeros(q.shape, np.int64)
    found = np.zeros(q.shape, bool)
    for mult in (int(HASH_MULT), int(HASH_MULT2)):
        b = ((q * np.uint64(mult)) & np.uint64(0xFFFFFFFF)) >> np.uint64(
            32 - art.hash_log2)
        rows = table[b.astype(np.int64)].astype(np.int64)
        for s0 in (0, 3):
            hit = ~found & (rows[:, s0] == q.astype(np.int64))
            start[hit] = rows[hit, s0 + 1]
            length[hit] = rows[hit, s0 + 2]
            found |= hit
    slices, mult = np.unique(np.stack([start[found], length[found]], 1),
                             axis=0, return_counts=True)
    postings = np.asarray(art.postings)
    rows = np.concatenate([postings[s:s + n] for s, n in slices] or
                          [np.empty(0, np.uint32)]).astype(np.int64)
    weights = np.repeat(mult, slices[:, 1]) if len(slices) else np.empty(0)
    bc = np.bincount(rows, weights=weights).astype(np.int64)
    nz = np.flatnonzero(bc)
    order = np.lexsort((nz, -bc[nz]))[:k]
    return nz[order], bc[nz[order]]


def check_counts(engine, art, queries, rng, n: int) -> int:
    pick = rng.choice(len(queries), size=n, replace=False)
    seqs = [queries[i] for i in pick]
    got = engine.count_batch(seqs, [len(s) - 6 for s in seqs], k=10)
    for s, qc in zip(seqs, got):
        # the engine keeps the top k_full = 16 >= k rows of positive count
        rows, counts = reference_topk(art, s, 16)
        check(len(qc.counts) == len(rows)
              and (qc.hit_rows.astype(np.int64) == rows).all()
              and (qc.counts == counts).all(),
              f"top-k of {s[:20]}...: engine {qc.hit_rows}, {qc.counts}; "
              f"reference {rows}, {counts}")
    return n


def check_alignments(engine, art, queries, body: bytes, rng, n: int,
                     device) -> int:
    """Served R2 rows vs result_from_ops of the plain SW versions on the
    card, for n sampled (query, subject) rows."""
    from kaamer_tpu_torch.ops import swalign as sw
    from kaamer_tpu_torch.ops import swalign_cuda as swc

    rows = [ln.split("\t") for ln in body.decode().splitlines()[1:]]
    rows = [rows[i] for i in rng.choice(len(rows), size=min(n, len(rows)),
                                        replace=False)]
    # entry id -> DB row, from the queries' own k-mer hits
    names = sorted({r[0] for r in rows})
    qseq = {nm: queries[int(nm[2:])] for nm in names}
    entry_row = {}
    for qc in engine.count_batch([qseq[nm] for nm in names],
                                 [len(qseq[nm]) - 6 for nm in names], k=10):
        for row in qc.hit_rows.tolist():
            entry_row[art.entry_id(row)] = row
    pairs = [(qseq[r[0]].replace("U", "*"),
              art.sequence(entry_row[r[1]]).replace("U", "*")) for r in rows]
    qc_, rc_, ql, rl, mat = pair_tensors(pairs, device)
    dirs, best = swc.sw_wavefront_plain(qc_, rc_, ql, rl, mat, 11, 1)
    score, q_ops, r_ops, n_ops = (t.cpu().numpy() for t in
                                  swc.sw_traceback_plain(dirs, best, ql))
    scores = sw.get_matrix_scores("blosum62", 11, 1)
    for b, ((q, r), row) in enumerate(zip(pairs, rows)):
        k = int(n_ops[b]) if score[b] > 0 else 0
        a = sw.result_from_ops(q, r, scores, q_ops[b, :k].tolist(),
                               r_ops[b, :k].tolist(), art.stats)
        want = [f"{a.Identity:.2f}", str(a.Length), str(a.Mismatches),
                str(a.GapOpenings), str(a.QueryStart), str(a.QueryEnd),
                str(a.SubjectStart), str(a.SubjectEnd), f"{a.EValue:e}",
                f"{a.BitScore:.2f}"]
        check(row[2:12] == want, f"served {row}, plain SW {want}")
    return len(rows)


class Served:
    """The port's HTTP server for one engine, on a free local port, for the
    duration of a with block (which yields the protein search URL)."""

    def __init__(self, engine):
        from kaamer_tpu_torch.server.app import make_server

        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        self.httpd = make_server(engine, 0, tmp, host="127.0.0.1")

    def __enter__(self):
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return (f"http://127.0.0.1:{self.httpd.server_address[1]}"
                "/api/search/protein")

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()


def serve_phase(engine, art, queries, rng, device, card: str):
    """R1-R3 through the port's HTTP server, then the on-card checks.
    Returns the kernels' launch counts over R1-R3 and the response
    bodies."""
    from kaamer_tpu_torch.ops import swalign as sw
    from kaamer_tpu_torch.ops import swalign_cuda as swc

    requests = (
        ("R1", 2048, {}),
        ("R2", 256, {"align": "true"}),
        ("R3", 64, {"output-format": "json", "positions": "true"}),
    )
    bodies = {}
    with Served(engine) as url:
        swc.reset_launches()
        host_before = sw.HOST_DP_PAIRS
        for name, n, extra in requests:
            fields = {"type": "string",
                      "sequence": fasta("r_", queries[:n]), **extra}
            status, body, wall = post(url, fields)
            bodies[name] = body
            check(status == 200, f"{name}: HTTP {status}")
            if extra.get("output-format") == "json":
                results = json.loads(body)["results"]
                n_hits = sum(len(r["SearchResults"]["Hits"]) for r in results)
                check(any(r["SearchResults"]["PositionHits"] for r in results),
                      f"{name}: no position hits")
            else:
                n_hits = body.count(b"\n") - 1
            check(n_hits > 0, f"{name}: no hits")
            print(f"{name}: {n} queries {extra or 'TSV defaults'} -> {status}, "
                  f"{n_hits} hits, {len(body)} bytes, wall {wall} s, "
                  f"{n / wall} queries/s [{card}]")
        launches = dict(swc.launches)
    print(f"main-path kernel launches: {launches}; host-DP pairs "
          f"(routing rule): {sw.HOST_DP_PAIRS - host_before}")
    for name, _ in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")

    n = check_counts(engine, art, queries, rng, 256)
    print(f"R1 check: {n} sampled queries' top-k rows and counts == numpy "
          f"bincount reference")
    n = check_alignments(engine, art, queries, bodies["R2"], rng, 256, device)
    print(f"R2 check: {n} sampled alignments == plain SW on the card")
    return launches, bodies


def cold_pass(art, device, queries, r1_body: bytes, card: str) -> None:
    """R1 again from SearchEngine(art, device, hot=False): both engines
    are exact, so the response bytes must be equal."""
    from kaamer_tpu_torch.search.engine import SearchEngine

    cold = SearchEngine(art, device, hot=False)
    check(cold.hot_starts is None, "the cold engine holds hot sets")
    with Served(cold) as url:
        status, body, wall = post(url, {"type": "string",
                                        "sequence": fasta("r_", queries)})
    check(status == 200, f"cold R1: HTTP {status}")
    print(f"cold R1 (hot=False): {len(queries)} queries, {len(body)} bytes, "
          f"wall {wall} s, {len(queries) / wall} queries/s, chunks "
          f"{cold.stats} [{card}]")
    check(body == r1_body, "cold R1 bytes != hot R1 bytes")
    print("cold R1 bytes == hot R1 bytes")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proteins", type=int, default=1_000_000,
                    help="skewed database size (bench.build_skewed_db)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import bench
    from kaamer_tpu_torch.ops import _kernels
    from kaamer_tpu_torch.search.engine import SearchEngine

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    print(smi)

    t0 = time.perf_counter()
    _kernels.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0} s "
          f"({_kernels.LIB_PATH})")
    print("\n".join(ln for ln in _kernels.build_log.splitlines()
                    if "registers" in ln or "spill" in ln))

    probe_rows = probe_phase(device, card)
    rng = np.random.default_rng(2026)
    kern = kernel_phase(device, rng, 512, 2048, min(8, os.cpu_count() or 1))

    t0 = time.perf_counter()
    os.makedirs(bench.CACHE_ROOT, exist_ok=True)
    path = os.path.join(bench.CACHE_ROOT, f"skew_{args.proteins}")
    art = bench.ensure_db(path, bench.build_skewed_db, args.proteins, 77)
    print(f"database: {art.num_proteins} proteins, {len(art.postings)} "
          f"postings, ready in {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    engine = SearchEngine(art, device)
    torch.cuda.synchronize(device)
    check(engine.hot_starts is not None, "the served engine has no hot sets")
    print(f"engine on {device} in {time.perf_counter() - t0} s, "
          f"{torch.cuda.memory_allocated(device)} bytes resident; "
          f"{engine.hot_starts.shape[0]} hot sets (len >= "
          f"{engine.hot_thresh}), M {tuple(engine.M.shape)} "
          f"{engine.M.dtype} {engine.M.numel() * engine.M.element_size()} "
          f"bytes")

    queries = bench.make_queries(art, rng, 2048)
    for key in engine.stats:
        engine.stats[key] = 0
    launches, bodies = serve_phase(engine, art, queries, rng, device, card)
    print(f"hot engine over R1-R3 and the checks: chunks hot "
          f"{engine.stats['hot']}, cold {engine.stats['cold']}, legacy "
          f"{engine.stats['legacy']}; certificate re-run rows "
          f"{engine.stats['rerun_rows']}")
    check(engine.stats["hot"] > 0, "no hot chunk was served")
    del engine
    cold_pass(art, device, queries, bodies["R1"], card)
    check("jax" not in sys.modules, "the port imported jax")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "kaamer_tpu_torch/csrc/swalign.cu", "replaces": replaces,
         "launches": launches[name], **kern[name]}
        for name, replaces in KERNELS] + probe_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
