#!/usr/bin/env python3
"""GPU smoke run of the torch port (kaamer_tpu_torch) on one CUDA card.

Drives the port's paths -- the probe microbenchmarks, and protein,
nucleotide and FASTQ search with and without -aln and position bitmaps,
served over HTTP from a domain-skewed database with hot sets on -- and
checks them.  Imports nothing of jax, the JAX package or the root
bench.py: the database comes from the port's own generator
(kaamer_tpu_torch.bench.data, the same seed-77 artifact).

  1. builds the CUDA kernels (csrc/*.cu, one nvcc each, in parallel);
  2. probe phase: every Pallas probe configuration of the scripts (P1-P6)
     through the port's entry points (kaamer_tpu_torch.bench.
     probe_microbench) at the scripts' sizes, then each kernel
     (row_dma_probe, smem_dyngather) against its plain torch version on
     the same inputs, exactly, with both timed (the kernel's call time and
     its device time alone), and row_dma_probe at depths 1, 8 and 16 at
     4096 and 2^20 copies; smem_dyngather at T = 8192 also at inner = 1
     and on uniformly random indices, each with its modelled wavefronts a
     warp gather;
  3. kernel phase: sw_align (the Smith-Waterman sweep and traceback, one
     warp a pair) on 512 random pairs (30-2048 residues) plus fixed
     cases, exactly equal to its plain torch version on the card, scores
     equal to the host DP; times it at B=256, m ~ n ~ 250, and in the
     longer query buckets;
  4. builds (or reuses, .bench_cache/skew_N) the skewed database and loads
     it onto the card with its hot sets;
  5. serves it with the port's server and POSTs R1 (2048 queries, TSV),
     R2 (256 queries, align=true), R3 (64 queries, JSON + positions), R4
     (8192 FASTQ reads, TSV: the lean translated path) and R5 (64
     contigs of 4 genes each, JSON + positions + align=true), each twice
     (the second is the warm wall), counting the first pass's kernel
     launches from 0; R2 and R5 must launch sw_align;
  6. sync proof: dispatch_batch and align_batch_dispatch under
     torch.cuda.set_sync_debug_mode("error"), and schedule_batch under
     "warn", which must wait for the card exactly once (the totals);
  7. checks sampled R1 counts and sampled R4/R5 served KMatch values
     against a numpy bincount reference, sampled R2 and R5 alignments
     against the plain SW versions on the card, R3 and R5 device bitmaps
     against the host binary search (member_np), and that R3 and R5 with
     the bitmap gate off (host bitmaps) give the same bytes;
  8. times the position-bitmap branch (torch.profiler, device time of a
     batch with and without bitmaps) and reads the peak device memory;
  9. serves R1, R3, R4 and R5 again from a cold engine (hot=False): the
     bytes must equal the hot engine's;
 10. shard phase: the same database on ShardedSearchEngine (per-shard
     hot sets) over a one-row grid -- with one card two shards sharing
     it, else min(4, cards) cards -- prints each shard's resident bytes,
     serves R1-R5 over HTTP twice each (every body equal to the hot
     single-device engine's; sw_align launches per request, R2 and R5
     must launch it), R3 and R5 with the bitmap gate off, and the sync
     proof of step 6 on the sharded dispatch_batch and schedule_batch;
 11. the dryrun_multichip twin (kaamer_tpu_torch.bench.multichip) on a
     (2, 2) grid of the cards, repeated as needed;
 12. a shard-built (2-shard) skewed database of 100,000 proteins (or
     --proteins, if fewer): R1 and R3 bytes equal its global build's on
     SearchEngine;
 13. lifecycle phase, at the same size, each step a subprocess of the
     port's CLI (python -m kaamer_tpu_torch.cli db|search ...): two
     -noindex halves of the same FASTA, -merge, -index, -backup, -restore
     and -gc, the restored artifact byte-equal to the global build;
     `db -server` on the restored database on the card, queried by `cli
     search` (R2 with -aln in path and file mode, R3 as JSON with
     positions, R5 as -t nt), each body equal to SearchEngine's on the
     global build; GET /, /web/ and /docs/README.md; the bench harness's
     opendb and a traced search (the trace must hold a CUDA kernel); and
     align_batch on R2's 256 pairs against the plain SW, its sw_align
     launches counted.

Prints the card (nvidia-smi name and power limit), per-request and
per-phase times, one JSON line of kernel results (each with its bound: the
larger of its bytes over 3.35 TB/s and its int32 operations over 16.7
T/s), and as its last line {"ok": true, "device": {...}}.  Any failure
raises (exit code != 0).

    python3 chip_smoke.py [--proteins N]
"""

from __future__ import annotations

import argparse
import filecmp
import http.client
import itertools
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from kaamer_tpu_torch.bench.serving import (Served, card_line, post,
                                            smoke_requests)

REPO = os.path.dirname(os.path.abspath(__file__))
AA = "ACDEFGHIKLMNPQRSTVWY"
KMER_ALPHABET = "ACDEFGHIKLMNPQRSTUVWY"  # the 21-letter 7-mer alphabet
KMER_SIZE = 7
# the main path's kernel and the Pallas kernel it replaces (with its XLA
# traceback, swalign_pallas.py:166)
KERNELS = (("sw_align", "kaamer_tpu/ops/swalign_pallas.py:50"),)
# H100 SXM peaks for the bounds: HBM 3.35 TB/s (NVIDIA's data sheet) and
# int32 operations at 132 SMs x 64 lanes x 1.98 GHz (the float32 rate of
# 67 TFLOP/s is 128 lanes an SM, an FMA counted twice; int32 has half the
# lanes)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations of one Smith-Waterman cell: e and f (two subtracts and
# a max each), h0 and h (an add, then three maxes: h0, e, f and zero), and
# the direction nibble (five compares, a shift and an or)
SW_OPS_PER_CELL = 17
# int32 instructions of one smem_dyngather element a round: the mask, the
# sum's add and the index update's multiply-add (its addend 7 + i is a
# constant of an unrolled round); the element's one shared-memory load
# goes at 32 banks (words) a clock an SM
DYNGATHER_OPS = 3
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9
# torch.profiler sessions tried before a device time falls back to CUDA events
PROFILER_TRIES = 3
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


def align_err(out_a, out_b):
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


def device_events(fn, reps: int):
    """The device activities (kernels, copies) torch.profiler records over
    reps calls of fn, after a warm call, by name."""
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
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time (ms) of the CUDA kernels whose name holds `kernel`
    over reps calls of fn, by torch.profiler: the kernel alone, without
    the host's launch cost.  The profiler may record fewer launches than
    were made (4 of 20 seen once on the H100, none of 20 once); the mean
    is over those it recorded.  When PROFILER_TRIES sessions record none,
    the time is the median call time by CUDA events instead, and the run
    says so."""
    for _ in range(PROFILER_TRIES):
        hits = [e for e in device_events(fn, reps) if kernel in e.key]
        if hits:
            return (sum(e.device_time_total for e in hits)
                    / sum(e.count for e in hits) / 1e3)
    ms = median_ms(fn, reps)
    print(f"torch.profiler recorded no launch of {kernel} in "
          f"{PROFILER_TRIES} x {reps} calls: its device time is the median "
          f"call time by CUDA events, {ms} ms")
    return ms


def device_total_ms(fn, reps: int = 3) -> float:
    """Device time (ms) of one call of fn: every kernel and copy that
    torch.profiler records over reps calls, summed, over reps.  Fails
    when PROFILER_TRIES sessions record no device time."""
    for _ in range(PROFILER_TRIES):
        total = sum(e.device_time_total for e in device_events(fn, reps))
        if total > 0:
            return total / reps / 1e3
    check(False, "the profiler recorded no device time")


def sw_bound(qc, rc, ql, rl, n_ops):
    """(bound ms, bound_by) of one sw_align call on these inputs: the
    larger of its int32 operations (SW_OPS_PER_CELL a valid cell) over
    INT32_OPS_PER_S and its bytes (inputs read once, the scores, lengths
    and the path entries written once) over HBM_BYTES_PER_S."""
    cells = int((ql.long() * rl.long()).sum())
    B = qc.shape[0]
    nbytes = (qc.numel() + rc.numel() + 8 * B + 24 * 24 * 4
              + 8 * B + 4 * int(n_ops.long().sum()))
    t_ops = cells * SW_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kernel_phase(device, rng, n_pairs: int, max_len: int, workers: int,
                 card: str):
    """sw_align vs its plain version on the card, scores vs the host DP,
    and its times at B=256, m ~ n ~ 250 (the -aln flush) and in longer
    query buckets.  Returns the sw_align result dict."""
    import torch

    from kaamer_tpu_torch.ops import swalign_cuda as swc

    pairs = random_pairs(rng, n_pairs, 30, max_len) + fixed_pairs()
    qc, rc, ql, rl, mat = pair_tensors(pairs, device)
    out = swc.sw_align(qc, rc, ql, rl, mat, 11, 1)
    p_out = swc.sw_align_plain(qc, rc, ql, rl, mat, 11, 1)
    torch.cuda.synchronize(device)
    res = {"max_abs_err": align_err(out, p_out)}
    with ProcessPoolExecutor(max_workers=workers, mp_context=
                             multiprocessing.get_context("spawn")) as pool:
        host = list(pool.map(_host_score, pairs, chunksize=8))
    scores = out[0].cpu().numpy()
    print(f"kernel phase: {len(pairs)} pairs (30-{max_len} residues), "
          f"sw_align max_abs_err {res['max_abs_err']} vs plain, scores == "
          f"host DP: {bool((scores == host).all())}")
    check(res["max_abs_err"] == 0, "sw_align disagrees with its plain version")
    check((scores == np.asarray(host)).all(), "kernel scores != host DP")
    check(scores[-2] > 0 and scores[-1] == 0,
          "self alignment must score, the no-hit pair must not")

    # the -aln serving shape (one flush of 256 pairs), then longer queries
    # (R = 16, 32 and 64 rows a lane; the global scratch from R = 24 on)
    res["configs"] = []
    for lo, hi in ((240, 260), (480, 510), (960, 1020), (1920, 2040)):
        args = pair_tensors(random_pairs(rng, 256, lo, hi), device)
        n_ops = swc.sw_align(*args, 11, 1)[3]
        bound, bound_by = sw_bound(*args[:4], n_ops)
        cfg = {"B": 256, "len": [lo, hi],
               "rows_per_lane": swc.rows_per_lane(args[0].shape[1]),
               "ms": median_ms(lambda: swc.sw_align(*args, 11, 1), 20),
               "device_ms": device_ms(lambda: swc.sw_align(*args, 11, 1),
                                      "sw_align_kernel"),
               "bound_ms": bound, "bound_by": bound_by}
        if lo == 240:
            cfg["plain_ms"] = median_ms(
                lambda: swc.sw_align_plain(*args, 11, 1), 3)
            res.update(ms=cfg["ms"], device_ms=cfg["device_ms"],
                       plain_ms=cfg["plain_ms"], bound_ms=bound,
                       bound_by=bound_by, library_ms=None)
        res["configs"].append(cfg)
        print(f"sw_align B=256 lengths {lo}-{hi} (R={cfg['rows_per_lane']}):"
              f" call {cfg['ms']} ms (median, CUDA events), device "
              f"{cfg['device_ms']} ms (torch.profiler mean), bound "
              f"{bound} ms by {bound_by} ({bound / cfg['device_ms']:.4f} of "
              f"it), plain torch {cfg.get('plain_ms', 'not timed')} ms "
              f"[{card}]")
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


def wavefronts(idx, T: int, inner: int) -> float:
    """Modelled shared-memory wavefronts of one smem_dyngather warp gather
    on these indices over every round (ops/probe_bench.py)."""
    from kaamer_tpu_torch.ops import probe_bench as pb

    return pb.dyngather_wavefronts(idx.cpu().numpy(), T, inner)


def probe_bound(kernel, args):
    """(bound ms, bound_by) of one probe call on args: row_dma_probe moves
    n rows and n indices; smem_dyngather reads x and idx once and does
    DYNGATHER_OPS int32 instructions and one shared-memory load an element
    a round (the slower of the two pipes)."""
    from kaamer_tpu_torch.ops import probe_bench as pb

    if kernel is pb.smem_dyngather:
        x, idx, T, inner = args
        gathers = T * 128 * inner
        t_ops = max(gathers * DYNGATHER_OPS / INT32_OPS_PER_S,
                    gathers / SMEM_WORDS_PER_S) * 1e3
        t_bytes = (x.numel() + idx.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    else:
        table, n = args[0], args[2]
        t_ops = 0.0
        t_bytes = n * (table.shape[1] * 4 + 4) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


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
        gather = kernel is pb.smem_dyngather
        work = args[2] * 128 * args[3] if gather else args[2]
        unit = "elems" if gather else "rows"
        bound, bound_by = probe_bound(kernel, args)
        print(f"{label} {kernel.__name__} {kw or 'script defaults'}: "
              f"checksum {got} == plain; entry point best-of-3 {secs} s; "
              f"kernel call {ms} ms ({work / ms / 1e3} M {unit}/s), "
              f"device {dev_ms} ms, bound {bound} ms by {bound_by} "
              f"({bound / dev_ms:.4f} of it), plain torch {plain_ms} ms "
              f"(call: median of CUDA events; device: torch.profiler mean)"
              + (f"; modelled wavefronts a warp gather "
                 f"{wavefronts(args[1], args[2], args[3])}" if gather
                 else "") + f" [{card}]")
        row = rows.setdefault(label, {
            "name": f"{label} {kernel.__name__}", "route": "cuda",
            "source": "kaamer_tpu_torch/csrc/probe_bench.cu",
            "launches": 0, "max_abs_err": 0, "configs": []})
        row["launches"] += n_launch
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["configs"].append({**kw, "launches": n_launch, "ms": ms,
                               "device_ms": dev_ms, "plain_ms": plain_ms,
                               "bound_ms": bound})
        if kw == PROBE_HEAD.get(label, kw):
            row.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None)

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
                "plain_ms": plain_ms,
                "bound_ms": probe_bound(kernel, args)[0]})
    rows["P4"]["configs"] += dyngather_configs(device, card)
    out = []
    for label, replaces in PROBES:
        row = rows[label]
        check(row["launches"] > 0, f"{label} launched no kernel")
        out.append({**row, "replaces": replaces})
    return out


def dyngather_configs(device, card: str):
    """smem_dyngather at P4's T = 8192 off the path, each exactly against
    its plain version: inner = 1 (the staging, the launch and one round of
    gathers) and uniformly random indices at inner = 32 (a layout not
    tuned to the scripts' hash).  Returns their config rows."""
    import torch

    from kaamer_tpu_torch.bench import probe_microbench as pmb
    from kaamer_tpu_torch.ops import probe_bench as pb

    T = 8192
    x, script_idx = pmb.v4_case(device, T=T)[2][:2]
    rng = np.random.default_rng(9)
    random_idx = torch.from_numpy(rng.integers(
        -2**31, 2**31, size=(T, 128), dtype=np.int64).astype(np.int32)
    ).to(device)
    out = []
    for name, idx, inner in (("inner=1", script_idx, 1),
                             ("random idx", random_idx, 32)):
        args = (x, idx, T, inner)
        got, want, ms, dev_ms, plain_ms = time_probe(
            pb.smem_dyngather, pb.smem_dyngather_plain, args)
        check(got == want, f"smem_dyngather {name}: kernel {got}, plain "
              f"{want}")
        bound = probe_bound(pb.smem_dyngather, args)[0]
        wf = wavefronts(idx, T, inner)
        print(f"P4 smem_dyngather T={T} {name}: checksum {got} == plain; "
              f"kernel call {ms} ms, device {dev_ms} ms, bound {bound} ms "
              f"({bound / dev_ms:.4f} of it), plain torch {plain_ms} ms; "
              f"modelled wavefronts a warp gather {wf} [{card}]")
        out.append({"T": T, "inner": inner, "case": name, "ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain_ms,
                    "bound_ms": bound})
    return out


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------


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
    from kaamer_tpu_torch.index.hashtable import HASH_MULT, HASH_MULT2

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
    pick = rng.choice(len(queries), size=min(n, len(queries)), replace=False)
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
    return len(seqs)


def plain_alignments(art, pairs, device):
    """result_from_ops of the plain SW versions on the card for (query,
    subject) pairs, 'U' read as '*' as the aligner reads it."""
    from kaamer_tpu_torch.ops import swalign as sw
    from kaamer_tpu_torch.ops import swalign_cuda as swc

    pairs = [(q.replace("U", "*"), r.replace("U", "*")) for q, r in pairs]
    qc_, rc_, ql, rl, mat = pair_tensors(pairs, device)
    dirs, best = swc.sw_wavefront_plain(qc_, rc_, ql, rl, mat, 11, 1)
    score, q_ops, r_ops, n_ops = (t.cpu().numpy() for t in
                                  swc.sw_traceback_plain(dirs, best, ql))
    scores = sw.get_matrix_scores("blosum62", 11, 1)
    out = []
    for b, (q, r) in enumerate(pairs):
        k = int(n_ops[b]) if score[b] > 0 else 0
        out.append(sw.result_from_ops(q, r, scores, q_ops[b, :k].tolist(),
                                      r_ops[b, :k].tolist(), art.stats))
    return out


def check_alignments(engine, art, queries, body: bytes, rng, n: int,
                     device) -> int:
    """Served R2 rows vs result_from_ops of the plain SW versions on the
    card, for n sampled (query, subject) rows."""
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
    pairs = [(qseq[r[0]], art.sequence(entry_row[r[1]])) for r in rows]
    for row, a in zip(rows, plain_alignments(art, pairs, device)):
        want = [f"{a.Identity:.2f}", str(a.Length), str(a.Mismatches),
                str(a.GapOpenings), str(a.QueryStart), str(a.QueryEnd),
                str(a.SubjectStart), str(a.SubjectEnd), f"{a.EValue:e}",
                f"{a.BitScore:.2f}"]
        check(row[2:12] == want, f"served {row}, plain SW {want}")
    return len(rows)


def json_hits(body: bytes):
    """(ORF key (name, plus strand, end position), result, hit) of every
    hit of a translated JSON answer."""
    out = []
    for r in json.loads(body)["results"]:
        q = r["Query"]
        key = (q["Name"].split(" ", 1)[0], q["Location"]["PlusStrand"],
               q["Location"]["EndPosition"])
        out += [(key, r, h) for h in r["SearchResults"]["Hits"]]
    return out


def check_json_alignments(art, body: bytes, rng, n: int, device) -> int:
    """Sampled hits of a translated JSON answer with -aln: each served
    Alignment equals result_from_ops of the plain SW versions on the card
    over the served ORF sequence and the subject."""
    hits = json_hits(body)
    pick = rng.choice(len(hits), size=min(n, len(hits)), replace=False)
    hits = [hits[i] for i in pick]
    pairs = [(r["Query"]["Sequence"], r["HitEntries"][str(h["Key"])]["Sequence"])
             for _, r, h in hits]
    for (_, _, h), a in zip(hits, plain_alignments(art, pairs, device)):
        check(h["Alignment"] == a.to_json_obj(),
              f"served {h['Alignment']}, plain SW {a.to_json_obj()}")
    return len(hits)


def records(text: str, fastq: bool):
    """(name, sequence) of each record of a FASTA or FASTQ text."""
    lines = text.splitlines()
    step = 4 if fastq else 2
    return [(lines[i][1:].split(" ", 1)[0], lines[i + 1])
            for i in range(0, len(lines), step)]


def orf_index(recs, gcode: int) -> dict:
    """(name, plus strand, end position) -> (ORF protein sequence, k-mer
    count) of every ORF translated search dispatches for these records."""
    from kaamer_tpu_torch.search.orf import get_orf_tuples_batch

    out = {}
    for (name, _), orfs in zip(recs, get_orf_tuples_batch(
            [s for _, s in recs], gcode, min_kmers=1)):
        for seq, n, _, ep, plus, _ in orfs:
            out[(name, plus, ep)] = (seq, n)
    return out


def check_translated_counts(art, index: dict, served, label, rng,
                            n: int) -> int:
    """n sampled served translated hits (ORF key, subject, KMatch): the
    subject is among reference_topk's top 16 over the ORF's searched
    k-mers, with the served count.  label maps a DB row to the subject as
    served (entry id or key)."""
    pick = rng.choice(len(served), size=min(n, len(served)), replace=False)
    by_orf = {}
    for i in pick:
        key, subject, km = served[i]
        by_orf.setdefault(key, []).append((subject, km))
    for key, hits in by_orf.items():
        seq, nk = index[key]
        rows, counts = reference_topk(art, seq[:nk + KMER_SIZE - 1], 16)
        ref = {label(int(r)): int(c) for r, c in zip(rows, counts)}
        for subject, km in hits:
            check(ref.get(subject) == km, f"{key} {subject}: served {km}, "
                  f"reference {ref.get(subject)}")
    return len(pick)


def check_bitmaps(engine, seqs, sizes) -> tuple:
    """count_batch with positions=True: every query served with device
    bitmaps has, for every hit, the bitmap of the host binary search
    (member_np).  Returns (queries with device bitmaps, queries, hits
    compared)."""
    got = engine.count_batch(seqs, sizes, k=10, positions=True)
    n_dev = n_hits = 0
    for qc in got:
        if qc._bitmaps is None:
            continue
        n_dev += 1
        rows = [int(r) for r in qc.hit_rows]
        dev = engine.position_bitmaps_np(qc, rows)
        host = engine._host_bitmaps_np(qc, rows)
        check(dev.keys() == host.keys()
              and all(np.array_equal(dev[r], host[r]) for r in rows),
              f"device bitmaps != member_np for hits {rows}")
        n_hits += len(rows)
    return n_dev, len(got), n_hits


def gate_off(fn):
    """fn() with the engine's bitmap gate (_positions_on_device) forced
    off, so every bitmap comes from the host binary search."""
    from kaamer_tpu_torch.search import engine as engine_mod

    saved = engine_mod._positions_on_device
    engine_mod._positions_on_device = lambda *a: False
    try:
        return fn()
    finally:
        engine_mod._positions_on_device = saved


def count_hits(name: str, body: bytes, fields: dict) -> int:
    if fields.get("output-format") == "json":
        results = json.loads(body)["results"]
        check(any(r["SearchResults"]["PositionHits"] for r in results),
              f"{name}: no position hits")
        return sum(len(r["SearchResults"]["Hits"]) for r in results)
    return body.count(b"\n") - 1


def serve_phase(engine, reqs, card: str):
    """R1-R5 through the port's HTTP server, each twice (the second is the
    warm wall), each with the launch counts set to 0 just before it and
    read just after.  Returns the kernels' launch counts summed over the
    first pass of R1-R5, and the response bodies."""
    from kaamer_tpu_torch.ops import swalign as sw
    from kaamer_tpu_torch.ops import swalign_cuda as swc

    bodies = {}
    launches = {name: 0 for name, _ in KERNELS}
    per_request = {}
    with Served(engine) as url:
        host_before = sw.HOST_DP_PAIRS
        for name, route, fields, unit in reqs:
            n = fields["sequence"].count("\n") // (4 if route == "fastq"
                                                   else 2)
            walls = []
            for rep in range(2):
                swc.reset_launches()
                status, body, wall = post(url + route,
                                          {"type": "string", **fields})
                check(status == 200, f"{name}: HTTP {status}")
                walls.append(wall)
                if rep == 0:
                    per_request[name] = dict(swc.launches)
                    for k, v in swc.launches.items():
                        launches[k] += v
                    bodies[name] = body
                check(body == bodies[name], f"{name}: the warm answer's bytes "
                      "differ from the first")
            n_hits = count_hits(name, body, fields)
            check(n_hits > 0, f"{name}: no hits")
            opts = {k: v for k, v in fields.items() if k != "sequence"}
            print(f"{name}: {n} {unit} via /api/search/{route} "
                  f"{opts or 'TSV defaults'} -> {status}, {n_hits} hits, {len(body)} bytes, wall "
                  f"{walls[0]} s, warm {walls[1]} s ({n / walls[1]} {unit}/s "
                  f"warm) [{card}]")
    print(f"main-path kernel launches per request (first pass): "
          f"{per_request}; host-DP pairs (routing rule): "
          f"{sw.HOST_DP_PAIRS - host_before}")
    for name in ("R2", "R5"):
        check(per_request[name]["sw_align"] > 0,
              f"{name} never launched sw_align")
    return launches, bodies


def sync_phase(engine, queries) -> None:
    """dispatch_batch and align_batch_dispatch under sync debug mode
    "error" (a synchronizing call raises), then schedule_batch under
    "warn": it must wait for the card exactly once, for the totals, on a
    batch with no query past CAP_MAX."""
    import warnings

    import torch

    from kaamer_tpu_torch.ops import swalign as sw

    seqs = queries[:256]
    sizes = [len(s) - 6 for s in seqs]
    pairs = list(zip(queries[0:64:2], queries[1:64:2]))
    for positions in (False, True):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = engine.dispatch_batch(seqs, sizes, k=10,
                                           positions=positions)
            aln = sw.align_batch_dispatch(pairs, engine.art.stats,
                                          "blosum62", 11, 1,
                                          device=engine.device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(aln[3] is not None, "align_batch_dispatch did not enqueue")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sched = engine.schedule_batch(handle)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        check(not sched[1], "a query of the batch went past CAP_MAX")
        check(len(syncs) == 1, f"schedule_batch waited for the card "
              f"{len(syncs)} times, not once: {syncs}")
        got = engine.collect_batch(sched)
        # with positions, the gate (_positions_on_device) decides per chunk
        n_dev = sum(qc._bitmaps is not None for qc in got)
        check(positions or n_dev == 0, f"{n_dev} queries with device "
              "bitmaps, none asked for")
        check(len(sw.align_batch_resolve(aln)) == len(pairs),
              "align_batch_resolve lost pairs")
        print(f"sync proof (positions={positions}): dispatch_batch of "
              f"{len(seqs)} queries and align_batch_dispatch of {len(pairs)}"
              f" pairs under sync debug mode 'error' raised nothing; "
              f"schedule_batch made {len(syncs)} synchronizing call (the "
              f"totals read); {n_dev} of {len(got)} queries on device "
              f"bitmaps")


def positions_profile(engine, queries, card: str) -> None:
    """The positions branch's device time: one count_batch of R3's 64 and
    R1's 2048 queries with and without position bitmaps, all device
    activity summed (torch.profiler)."""
    for n in (64, 2048):
        seqs = queries[:n]
        sizes = [len(s) - 6 for s in seqs]
        ms = {pos: device_total_ms(lambda: engine.count_batch(
            seqs, sizes, k=10, positions=pos)) for pos in (False, True)}
        print(f"positions branch, {n} queries: device {ms[True]} ms with "
              f"bitmaps, {ms[False]} ms without, {ms[True] - ms[False]} ms "
              f"for the bitmaps (torch.profiler, mean of 3) [{card}]")


def check_phase(engine, art, queries, reqs, bodies, rng, device):
    """The on-card checks of the served answers."""
    from kaamer_tpu_torch.server.app import _default_options
    from kaamer_tpu_torch.search.options import NUCLEOTIDE

    n = check_counts(engine, art, queries, rng, 256)
    print(f"R1 check: {n} sampled queries' top-k rows and counts == numpy "
          f"bincount reference")
    n = check_alignments(engine, art, queries, bodies["R2"], rng, 256, device)
    print(f"R2 check: {n} sampled alignments == plain SW on the card")

    gcode = _default_options(NUCLEOTIDE).GeneticCode
    fields = {name: f for name, _, f, _ in reqs}
    routes = {name: route for name, route, _, _ in reqs}
    reads = records(fields["R4"]["sequence"], fastq=True)
    contigs = records(fields["R5"]["sequence"], fastq=False)
    idx4, idx5 = orf_index(reads, gcode), orf_index(contigs, gcode)

    seqs = queries[:64]
    n_dev, n_q, n_hits = check_bitmaps(engine, seqs,
                                       [len(s) - 6 for s in seqs])
    check(n_dev > 0, "R3: no query got device bitmaps")
    print(f"R3 bitmaps: {n_dev} of {n_q} queries on device bitmaps, "
          f"{n_hits} hits' bitmaps == member_np")
    orfs = list(idx5.values())
    pick = rng.choice(len(orfs), size=min(256, len(orfs)), replace=False)
    n_dev, n_q, n_hits = check_bitmaps(engine, [orfs[i][0] for i in pick],
                                       [orfs[i][1] for i in pick])
    check(n_dev > 0, "R5: no ORF got device bitmaps")
    print(f"R5 bitmaps: {n_dev} of {n_q} sampled ORFs on device bitmaps, "
          f"{n_hits} hits' bitmaps == member_np")

    with Served(engine) as url:
        for name in ("R3", "R5"):
            status, body, wall = gate_off(lambda: post(
                url + routes[name], {"type": "string", **fields[name]}))
            check(status == 200 and body == bodies[name],
                  f"{name}: host-bitmap bytes != device-bitmap bytes")
            print(f"{name} with the bitmap gate off (host bitmaps): bytes == "
                  f"device-bitmap bytes, wall {wall} s")

    served4 = []
    for ln in bodies["R4"].decode().splitlines()[1:]:
        c = ln.split("\t")
        sp, ep = int(c[6]), int(c[7])
        served4.append(((c[0], sp < ep, ep), c[1], int(c[4])))
    n = check_translated_counts(art, idx4, served4, art.entry_id, rng, 256)
    print(f"R4 check: {n} sampled served hits' KMatch == numpy bincount "
          f"reference over the read's ORF")
    keys = np.asarray(art.protein_ids)
    served5 = [(key, h["Key"], h["Kmatch"])
               for key, _, h in json_hits(bodies["R5"])]
    n = check_translated_counts(art, idx5, served5,
                                lambda r: int(keys[r]), rng, 256)
    print(f"R5 check: {n} sampled served hits' KMatch == numpy bincount "
          f"reference over the contig's ORF")
    n = check_json_alignments(art, bodies["R5"], rng, 256, device)
    print(f"R5 check: {n} sampled alignments == plain SW on the card")


def cold_pass(art, device, reqs, bodies, card: str) -> None:
    """R1, R3, R4 and R5 again from SearchEngine(art, device, hot=False):
    both engines are exact, so the response bytes must be equal."""
    from kaamer_tpu_torch.search.engine import SearchEngine

    cold = SearchEngine(art, device, hot=False)
    check(cold.hot_starts is None, "the cold engine holds hot sets")
    with Served(cold) as url:
        for name, route, fields, unit in reqs:
            if name == "R2":
                continue
            status, body, wall = post(url + route,
                                      {"type": "string", **fields})
            check(status == 200, f"cold {name}: HTTP {status}")
            check(body == bodies[name], f"cold {name} bytes != hot {name} "
                  "bytes")
            print(f"cold {name} (hot=False): {len(body)} bytes == hot, wall "
                  f"{wall} s [{card}]")
    print(f"cold engine chunks over R1, R3-R5: {cold.stats}")


# ---------------------------------------------------------------------------
# shard phase
# ---------------------------------------------------------------------------


def shard_grid(cards, n_shards: int = 0):
    """The shard phase's (dp, shard) grid: one dp row; on one card two
    shards sharing it, else min(4, cards) cards (n_shards of them when
    given)."""
    if len(cards) == 1:
        return [cards * (n_shards or 2)]
    return [cards[: n_shards or min(4, len(cards))]]


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def shard_sync(engine, queries) -> None:
    """sync_phase's proof on the sharded engine: dispatch_batch under
    sync debug mode "error", then schedule_batch under "warn", which must
    wait for the card exactly once (the totals read)."""
    import warnings

    import torch

    seqs = queries[:256]
    sizes = [len(s) - 6 for s in seqs]
    for positions in (False, True):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = engine.dispatch_batch(seqs, sizes, k=10,
                                           positions=positions)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sched = engine.schedule_batch(handle)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        check(not sched[1], "a query of the batch went past CAP_MAX")
        check(len(syncs) == 1, f"sharded schedule_batch waited for the card "
              f"{len(syncs)} times, not once: {syncs}")
        got = engine.collect_batch(sched)
        print(f"sharded sync proof (positions={positions}): dispatch_batch "
              f"of {len(seqs)} queries under sync debug mode 'error' raised "
              f"nothing; schedule_batch made {len(syncs)} synchronizing call"
              f" (the totals read); {len(got)} queries collected")


def shard_phase(art, reqs, bodies, queries, card: str, cards) -> dict:
    """R1-R5 over HTTP through ShardedSearchEngine on the 1M database, each
    twice, each body equal to the hot single-device engine's; R3 and R5
    again with the bitmap gate off; the sync proof.  Returns each kernel's
    launches per request, counted from 0 just before each first pass."""
    import gc

    import torch

    from kaamer_tpu_torch.ops import probe_bench as pb
    from kaamer_tpu_torch.ops import swalign_cuda as swc
    from kaamer_tpu_torch.parallel.dist import NO_START, ShardedSearchEngine

    gc.collect()
    torch.cuda.empty_cache()
    grid = shard_grid(cards)
    devs = sorted({d for row in grid for d in row}, key=str)
    base = {d: torch.cuda.memory_allocated(d) for d in devs}
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    eng = ShardedSearchEngine(art, grid)
    torch.cuda.synchronize()
    check(eng.hot_starts is not None, "the sharded engine has no hot sets")
    print(f"sharded engine on {[[str(d) for d in r] for r in grid]} (dp "
          f"{eng.dp}, {eng.n_shards} shards{', sharing one card' if len(devs) < eng.n_shards else ''}): "
          f"built in {time.perf_counter() - t0} s [{card}]")
    for s in range(eng.n_shards):
        M, MT = eng.M[0][s], eng.MT[0][s]
        n_hot = int((eng.hot_starts[0][s] < NO_START).sum())
        print(f"  shard {s} on {grid[0][s]}: table {nbytes(eng.tables[0][s])}"
              f" bytes, postings {nbytes(eng.postings[0][s])} "
              f"({eng.sharded.postings_sizes[s]} real), {n_hot} hot sets "
              f"(len >= {eng.hot_thresh_np[s]}), M {tuple(M.shape)} "
              f"{M.dtype} {nbytes(M)} bytes, MT {tuple(MT.shape)} {MT.dtype} "
              f"{nbytes(MT)} bytes")
    print(f"sharded engine resident: "
          f"{sum(torch.cuda.memory_allocated(d) - base[d] for d in devs)} "
          f"bytes over {[str(d) for d in devs]} [{card}]")

    per_request = {}
    with Served(eng) as url:
        for name, route, fields, unit in reqs:
            walls = []
            for rep in range(2):
                swc.reset_launches()
                pb.reset_launches()
                status, body, wall = post(url + route,
                                          {"type": "string", **fields})
                check(status == 200, f"sharded {name}: HTTP {status}")
                check(body == bodies[name], f"sharded {name} bytes != the "
                      "single-device engine's")
                walls.append(wall)
                if rep == 0:
                    per_request[name] = {**swc.launches, **pb.launches}
            print(f"sharded {name}: {len(body)} bytes == single-device, wall "
                  f"{walls[0]} s, warm {walls[1]} s [{card}]")
        for name in ("R3", "R5"):
            fields = next(f for n, _, f, _ in reqs if n == name)
            route = next(r for n, r, _, _ in reqs if n == name)
            status, body, wall = gate_off(lambda: post(
                url + route, {"type": "string", **fields}))
            check(status == 200 and body == bodies[name],
                  f"sharded {name}: host-bitmap bytes != device-bitmap bytes")
            print(f"sharded {name} with the bitmap gate off (host bitmaps): "
                  f"bytes == single-device, wall {wall} s")
    print(f"sharded kernel launches per request (first pass): {per_request};"
          f" groups over R1-R5 and the gate-off passes: {eng.stats}")
    for name in ("R2", "R5"):
        check(per_request[name]["sw_align"] > 0,
              f"sharded {name} never launched sw_align")
    check(eng.stats["hot"] > 0, "no sharded hot group was served")
    shard_sync(eng, queries)
    for d in devs:
        print(f"peak device memory with the sharded engine on {d}: "
              f"{torch.cuda.max_memory_allocated(d)} bytes [{card}]")
    # the server's handler class holds the engine in a reference cycle:
    # free it before the next phases allocate
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return per_request


def dryrun_phase(cards) -> None:
    """The dryrun_multichip twin on a (2, 2) grid of the cards, repeated
    as needed: global and shard-built artifacts == SearchEngine bytes."""
    from kaamer_tpu_torch.bench.multichip import device_grid, dryrun_multichip

    grid = device_grid(2, 2, cards)
    dryrun_multichip(grid)
    print(f"dryrun_multichip twin on "
          f"{[[str(d) for d in r] for r in grid]}: global and shard-built "
          f"bytes == SearchEngine")


def shard_built_phase(n_proteins: int, card: str, cards) -> None:
    """A shard-built artifact (index_db with 2 shards) of the skewed
    generator's proteins, served by ShardedSearchEngine: R1 and R3 bytes
    equal a global build of the same input served by SearchEngine."""
    from kaamer_tpu_torch.bench import data
    from kaamer_tpu_torch.parallel.dist import ShardedSearchEngine
    from kaamer_tpu_torch.search.engine import SearchEngine

    root = os.path.join(data.CACHE_ROOT, f"skew_{n_proteins}")
    t0 = time.perf_counter()
    g = data.ensure_db(root, data.build_skewed_db, n_proteins, 77)
    t1 = time.perf_counter()
    s = data.ensure_db(root + "_shards2", data.build_skewed_db, n_proteins,
                       77, 2)
    t2 = time.perf_counter()
    check(s.index_shards == 2, f"built {s.index_shards} shards, not 2")
    print(f"{n_proteins}-protein databases: global ready in {t1 - t0} s, "
          f"2-shard build in {t2 - t1} s")
    _, reqs = smoke_requests(g, np.random.default_rng(2026))
    engines = (SearchEngine(g, cards[0]),
               ShardedSearchEngine(s, shard_grid(cards, 2)))
    for name, route, fields, _ in reqs:
        if name not in ("R1", "R3"):
            continue
        got = []
        for eng in engines:
            with Served(eng) as url:
                status, body, wall = post(url + route,
                                          {"type": "string", **fields})
            check(status == 200, f"shard-built {name}: HTTP {status}")
            got.append((body, wall))
        check(got[0][0] == got[1][0], f"shard-built {name} bytes != the "
              "global build's")
        print(f"shard-built {n_proteins} {name}: {len(got[1][0])} bytes == "
              f"global build on SearchEngine; first walls {got[0][1]} s "
              f"(global) / {got[1][1]} s (shard-built) [{card}]")


# ---------------------------------------------------------------------------
# lifecycle phase
# ---------------------------------------------------------------------------


def run_module(module: str, args, what: str, card: str) -> str:
    """`python -m module args` in a subprocess from the repo's root; fails
    the run unless it exits 0.  Prints its wall; returns its stdout."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print(f"lifecycle {what}: wall {wall} s [{card}]")
    return proc.stdout


def same_artifact(got: str, want: str) -> list:
    """Every file of the artifact got equals want's, byte for byte, but
    meta.json, whose settings may differ in Name (a merge names the
    merged database after its first part, as the JAX package's does) and
    CreationDate (the day each was built): its stats and the rest of its
    settings must be equal.  Returns the files compared."""
    names = sorted(os.listdir(got))
    check(names == sorted(os.listdir(want)),
          f"restored files {names} != {sorted(os.listdir(want))}")
    for name in names:
        if name == "meta.json":
            metas = [json.load(open(os.path.join(d, name)))
                     for d in (got, want)]
            for m in metas:
                for key in ("Name", "CreationDate"):
                    m["settings"].pop(key, None)
            check(metas[0] == metas[1], f"meta.json {metas[0]} != {metas[1]}")
        else:
            check(filecmp.cmp(os.path.join(got, name),
                              os.path.join(want, name), shallow=False),
                  f"restored {name} != the global build's")
    return names


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(port: int, path: str):
    """(status, Location, body) of GET path on this machine, redirects not
    followed."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Location"), resp.read()
    finally:
        conn.close()


def wait_listening(proc, port: int, log: str, timeout: float = 600) -> float:
    """Seconds until the server answers /api/dbinfo; fails if it exits or
    the timeout passes first."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        check(proc.poll() is None, f"the CLI server exited "
              f"{proc.returncode}: {open(log).read()[-4000:]}")
        try:
            if http_get(port, "/api/dbinfo")[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.5)
    check(False, f"the CLI server did not answer in {timeout} s")


def trace_kernels(path: str) -> list:
    """The names of the CUDA kernel events of a torch.profiler Chrome
    trace."""
    events = json.load(open(path))["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def lifecycle_phase(n_proteins: int, card: str, device) -> int:
    """The database lifecycle through the port's CLI, each step a
    subprocess: two -noindex halves of the seed-77 skewed FASTA, -merge,
    -index, -backup, -restore and -gc; the restored artifact against the
    global build of the same FASTA (shard_built_phase's); the restored
    database served by `cli db -server` on the card and queried by `cli
    search` (R2 -aln in path and file mode, R3's queries as JSON with
    positions, R5's contigs as -t nt with R5's options), each body equal
    to the same request to SearchEngine on the global build; the static
    routes; the harness's opendb and a traced search on the card; and
    align_batch on R2's pairs against the plain SW.  Returns align_batch's
    sw_align launches."""
    import shutil

    from kaamer_tpu_torch.bench import data
    from kaamer_tpu_torch.bench.harness import TRACE_FILE
    from kaamer_tpu_torch.ops import swalign as sw
    from kaamer_tpu_torch.ops import swalign_cuda as swc
    from kaamer_tpu_torch.search.engine import SearchEngine

    root = os.path.join(data.CACHE_ROOT, "lifecycle")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "tmp"))
    fasta = os.path.join(root, f"skew_{n_proteins}.fasta")
    data.write_skewed_fasta(fasta, n_proteins, 77)
    half = n_proteins // 2

    def db(what, *args):
        return run_module("kaamer_tpu_torch.cli", ["db", *args], what, card)

    make = ["-make", "-i", fasta, "-f", "fasta", "-noindex"]
    p = {d: os.path.join(root, d) for d in ("parts", "merged", "bkp", "rst")}
    db("-make first half", *make, "-d", os.path.join(p["parts"], "a"),
       "-offset", 0, "-length", half)
    db("-make second half", *make, "-d", os.path.join(p["parts"], "b"),
       "-offset", half)
    db("-merge", "-merge", "-dbs", p["parts"], "-o", p["merged"])
    db("-index", "-index", "-d", p["merged"])
    db("-backup", "-backup", "-d", p["merged"], "-o", p["bkp"])
    db("-restore", "-restore", "-d", p["bkp"], "-o", p["rst"])
    out = db("-gc", "-gc", "-d", p["rst"])
    check("# GC done (0 bytes reclaimed" in out, f"-gc printed {out!r}")
    g_path = os.path.join(data.CACHE_ROOT, f"skew_{n_proteins}")
    g = data.ensure_db(g_path, data.build_skewed_db, n_proteins, 77)
    names = same_artifact(p["rst"], g_path)
    print(f"lifecycle: the restored artifact's {len(names)} files == the "
          f"global build's, byte for byte, but meta.json's settings Name "
          f"and CreationDate (its stats and other settings equal)")

    queries, reqs = smoke_requests(g, np.random.default_rng(2026))
    req = {name: (route, fields) for name, route, fields, _ in reqs}
    for name in ("R2", "R3", "R5"):
        with open(os.path.join(root, f"{name}.fasta"), "w") as f:
            f.write(req[name][1]["sequence"])

    port = free_port()
    log = os.path.join(root, "server.log")
    with open(log, "w") as logf:
        server = subprocess.Popen(
            [sys.executable, "-m", "kaamer_tpu_torch.cli", "db", "-server",
             "-d", p["rst"], "-p", str(port), "-tmp",
             os.path.join(root, "tmp")],
            cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)
    try:
        ready = wait_listening(server, port, log)
        print(f"lifecycle `cli db -server` on the restored database: "
              f"answering after {ready} s [{card}]")
        engine = SearchEngine(g, device)
        searches = (
            ("R2 -aln, path mode", "R2", "localhost",
             ["-t", "prot", "-aln"]),
            ("R2 -aln, file mode", "R2", "127.0.0.2",
             ["-t", "prot", "-aln"]),
            ("R3 -fmt json -pos", "R3", "localhost",
             ["-t", "prot", "-fmt", "json", "-pos"]),
            ("R5 -t nt -fmt json -pos -aln", "R5", "localhost",
             ["-t", "nt", "-fmt", "json", "-pos", "-aln"]),
        )
        with Served(engine) as url:
            want = {}
            for name in ("R2", "R3", "R5"):
                route, fields = req[name]
                status, want[name], _ = post(url + route,
                                             {"type": "string", **fields})
                check(status == 200, f"in-process {name}: HTTP {status}")
        # the restored server's first request, then the same again (warm)
        route, fields = req["R1"]
        walls = []
        for _ in range(2):
            status, body, wall = post(
                f"http://127.0.0.1:{port}/api/search/{route}",
                {"type": "string", **fields})
            check(status == 200 and body.count(b"\n") > 2048,
                  f"R1 to the CLI server: HTTP {status}, {len(body)} bytes")
            walls.append(wall)
        print(f"lifecycle R1 to the CLI server: first {walls[0]} s, warm "
              f"{walls[1]} s [{card}]")
        for what, name, host, opts in searches:
            out_path = os.path.join(root, f"{name}.out")
            run_module("kaamer_tpu_torch.cli", [
                "search", "-i", os.path.join(root, f"{name}.fasta"),
                "-h", f"http://{host}:{port}", "-o", out_path, *opts],
                f"`cli search` {what}", card)
            got = open(out_path, "rb").read()
            check(got == want[name], f"`cli search` {what}: {len(got)} "
                  f"bytes != SearchEngine on the global build's "
                  f"{len(want[name])}")
            print(f"  {len(got)} bytes == SearchEngine on the global build")

        status, location, body = http_get(port, "/")
        check(status == 302 and location == "/web/" and body == b"",
              f"GET /: {status} {location}")
        for path, rel in (("/web/", "web/public/index.html"),
                          ("/docs/README.md", "docs/README.md")):
            status, _, body = http_get(port, path)
            check(status == 200 and body == open(os.path.join(REPO, rel),
                                                 "rb").read(),
                  f"GET {path}: {status}, {len(body)} bytes")
        print("lifecycle static routes: GET / -> 302 Location /web/; "
              "/web/ and /docs/README.md -> 200 with the files' bytes")
    finally:
        server.terminate()
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()

    harness = "kaamer_tpu_torch.bench.harness"
    out = run_module(harness, ["-func", "opendb", "-d", p["rst"],
                               "-monitor", os.path.join(root, "opendb.out")],
                     "harness -func opendb", card)
    print("  " + "; ".join(ln for ln in out.splitlines()
                           if ln.startswith(("opendb", "MaxRSS"))))
    trace_dir = os.path.join(root, "trace")
    out = run_module(harness, ["-func", "search", "-d", p["rst"], "-i",
                               os.path.join(root, "R2.fasta"), "-trace",
                               trace_dir, "-monitor",
                               os.path.join(root, "search.out")],
                     "harness -func search -trace (R2's queries)", card)
    kernels = trace_kernels(os.path.join(trace_dir, TRACE_FILE))
    check(kernels, "the harness trace holds no CUDA kernel event")
    print("  " + "; ".join(ln for ln in out.splitlines()
                           if ln.startswith(("search", "MaxRSS"))))
    print(f"  trace: {len(kernels)} CUDA kernel events, "
          f"{len(set(kernels))} kernels")

    # align_batch on R2's pairs: each of the 256 queries with its top hit
    seqs = queries[:256]
    top = engine.count_batch(seqs, [len(s) - 6 for s in seqs], k=1)
    pairs = [(s, g.sequence(int(qc.hit_rows[0])))
             for s, qc in zip(seqs, top) if len(qc.hit_rows)]
    swc.reset_launches()
    t0 = time.perf_counter()
    got = sw.align_batch(pairs, g.stats, device=device)
    wall = time.perf_counter() - t0
    n_launch = swc.launches["sw_align"]
    check(n_launch > 0, "align_batch never launched sw_align")
    plain = plain_alignments(g, pairs, device)
    check([a.to_json_obj() for a in got] == [a.to_json_obj() for a in plain],
          "align_batch != the plain SW versions")
    print(f"lifecycle align_batch: {len(pairs)} pairs (R2's queries and "
          f"their top hits) == plain SW on the card; {n_launch} sw_align "
          f"launches; wall {wall} s [{card}]")
    del engine
    return n_launch


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proteins", type=int, default=1_000_000,
                    help="skewed database size (kaamer_tpu_torch.bench.data."
                    "build_skewed_db)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one card",
              file=sys.stderr)
        return 1
    from kaamer_tpu_torch import native
    from kaamer_tpu_torch.bench import data
    from kaamer_tpu_torch.ops import _kernels
    from kaamer_tpu_torch.search.engine import SearchEngine

    device = torch.device("cuda", 0)
    smi = card_line()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    print(smi)
    phases = {}
    t_run = t0 = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t0
        phases[name] = time.perf_counter() - t0
        print(f"phase {name}: {phases[name]} s")
        t0 = time.perf_counter()

    _kernels.lib()
    print(f"kernels built and loaded ({_kernels.LIB_PATH})")
    # ptxas -v: one line per kernel with its registers and spills
    for ln in _kernels.build_log.splitlines():
        if "Compiling entry function" in ln:
            print(ln.split("'")[1], end=": ")
        elif "spill stores" in ln or "Used" in ln and "registers" in ln:
            print(ln.split(":", 1)[-1].strip(), end="; " if "spill" in ln
                  else "\n")
    phase("build")

    probe_rows = probe_phase(device, card)
    phase("probe")
    rng = np.random.default_rng(2026)
    kern = kernel_phase(device, rng, 512, 2048, min(8, os.cpu_count() or 1),
                        card)
    phase("kernel")

    os.makedirs(data.CACHE_ROOT, exist_ok=True)
    path = os.path.join(data.CACHE_ROOT, f"skew_{args.proteins}")
    art = data.ensure_db(path, data.build_skewed_db, args.proteins, 77)
    print(f"database: {art.num_proteins} proteins, {len(art.postings)} "
          f"postings; native host library: {native.available()}")
    phase("database")
    engine = SearchEngine(art, device)
    torch.cuda.synchronize(device)
    check(engine.hot_starts is not None, "the served engine has no hot sets")
    print(f"engine on {device}: {torch.cuda.memory_allocated(device)} bytes "
          f"resident; {engine.hot_starts.shape[0]} hot sets (len >= "
          f"{engine.hot_thresh}), M {tuple(engine.M.shape)} {engine.M.dtype} "
          f"{engine.M.numel() * engine.M.element_size()} bytes, MT "
          f"{tuple(engine.MT.shape)} {engine.MT.dtype} "
          f"{engine.MT.numel() * engine.MT.element_size()} bytes")
    phase("engine")

    queries, reqs = smoke_requests(art, np.random.default_rng(2026))
    for key in engine.stats:
        engine.stats[key] = 0
    launches, bodies = serve_phase(engine, reqs, card)
    print(f"hot engine over R1-R5 (two passes): chunks hot "
          f"{engine.stats['hot']}, cold {engine.stats['cold']}, legacy "
          f"{engine.stats['legacy']}; certificate re-run rows "
          f"{engine.stats['rerun_rows']}")
    check(engine.stats["hot"] > 0, "no hot chunk was served")
    phase("serve")

    sync_phase(engine, queries)
    phase("sync")
    check_phase(engine, art, queries, reqs, bodies, rng, device)
    phase("checks")
    positions_profile(engine, queries, card)
    phase("profile")
    print(f"peak device memory with the hot engine: "
          f"{torch.cuda.max_memory_allocated(device)} bytes [{card}]")
    del engine
    cold_pass(art, device, reqs, bodies, card)
    phase("cold")
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    shard_launches = shard_phase(art, reqs, bodies, queries, card, cards)
    phase("shard")
    dryrun_phase(cards)
    phase("dryrun")
    shard_built_phase(min(args.proteins, 100_000), card, cards)
    phase("shard_built")
    aln_launches = lifecycle_phase(min(args.proteins, 100_000), card, device)
    phase("lifecycle")
    print(f"peak device memory over the run: "
          f"{torch.cuda.max_memory_allocated(device)} bytes [{card}]")
    imported = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "kaamer_tpu", "bench")]
    check(not imported, f"the port imported {imported}")
    print(f"phases (s): {json.dumps(phases)}; total "
          f"{time.perf_counter() - t_run} s")

    def sharded(name):
        return {r: shard_launches[r][name] for r in ("R2", "R5")}

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "kaamer_tpu_torch/csrc/swalign.cu", "replaces": replaces,
         "launches": launches[name], "sharded_launches": sharded(name),
         "align_batch_launches": aln_launches, **kern}
        for name, replaces in KERNELS] + [
        {**row, "sharded_launches": sharded(row["name"].split()[1])}
        for row in probe_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
