"""The port's own spans and counters (kaamer_tpu_torch/trace.py): off,
span() hands out one shared no-op and never reaches the profiler; under
a profiler of every thread, a POST to the threading HTTP server records
the `kaamer.` spans of its route on its handler thread, inside its one
`kaamer.request`, nested with no partial overlap (so none is held open
across a yield); the answers' bytes do not change when the profiler
runs; each blocking device-to-host read of the engine is one
`kaamer.engine.sync` span and one engine.stats["syncs"]; the warmup
leaves the counters alone.  On a hot CPU engine over a small seed-77
skewed database, as tests/test_torch_concurrent.py."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kaamer_tpu_torch import trace
from kaamer_tpu_torch.bench import data
from kaamer_tpu_torch.bench.serving import Served, post, requests
from kaamer_tpu_torch.search import engine as te
from kaamer_tpu_torch.search.engine import SearchEngine

from test_torch_sync import count_reads

ENGINE = ("engine.schedule", "engine.phase1", "engine.plan", "engine.chunk",
          "engine.sync")
SERVED = ("request", "pipeline.results") + ENGINE
# spans whose parent is the request itself
TOP = ("pipeline.results", "engine.phase1", "engine.schedule")
COUNTERS = ("batches", "syncs", "host_rows", "host_bitmap_rows")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A hot CPU engine on a 1,500-protein skewed DB and three requests
    of bench/serving.py: R1 (protein TSV, 24 queries), R3 (protein JSON
    with positions) and R4 (FASTQ reads, lean TSV, 96 reads)."""
    art = data.ensure_db(str(tmp_path_factory.mktemp("trace") / "skew"),
                         data.build_skewed_db, 1500)
    engine = SearchEngine(art, "cpu")
    assert engine.hot_starts is not None
    rng = np.random.default_rng(2026)
    queries = data.make_queries(art, rng, 24)
    reqs = requests(queries, data.make_reads_fastq(art, rng, 96),
                    data.make_contigs_fasta(art, rng, 1))
    reqs = {name: (route, {"type": "string", **fields})
            for name, route, fields, _ in reqs if name in ("R1", "R3", "R4")}
    return engine, reqs, queries


def _post(url, route, fields):
    """POST and wait for the handler thread to end, so that its spans
    are closed before the profiler stops."""
    before = set(threading.enumerate())
    status, body, _ = post(url + route, fields)
    for t in set(threading.enumerate()) - before:
        t.join(timeout=60)
        assert not t.is_alive()
    return status, body


def _recorded(fn, tmp_path):
    """fn() under a CPU profiler of every thread (as benchmark/run.py
    traces); (its result, the `kaamer.` spans as (name without the
    prefix, thread, start us, end us))."""
    prof = profile(activities=[ProfilerActivity.CPU], experimental_config=(
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [(e["name"][len("kaamer."):], e["tid"], e["ts"],
                  e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e["name"].startswith("kaamer.")]


def _nest(spans):
    """The spans of each thread nest: a span that starts inside another
    ends inside it.  Returns {(name, parent name or None)}."""
    by, parents = {}, set()
    for s in spans:
        by.setdefault(s[1], []).append(s)
    for v in by.values():
        stack = []
        for name, _, t0, t1 in sorted(v, key=lambda s: (s[2], -s[3])):
            while stack and stack[-1][1] <= t0:
                stack.pop()
            assert not stack or t1 <= stack[-1][1], (name, stack[-1])
            parents.add((name, stack[-1][0] if stack else None))
            stack.append((name, t1))
    return parents


def test_off_span_is_one_shared_noop_and_serves_without_the_profiler(
        served, monkeypatch):
    """(a) With no profiler, span() returns the one shared no-op object
    and never calls record_function: with record_function raising, a
    request still serves, with the same bytes."""
    engine, reqs, _ = served
    assert trace.span("kaamer.request") is trace.span("kaamer.engine.sync")
    with Served(engine) as url:
        want = _post(url, *reqs["R1"])

        def refuse(name):
            raise AssertionError(f"record_function({name!r}) called")
        monkeypatch.setattr(trace, "record_function", refuse)
        assert _post(url, *reqs["R1"]) == want
    assert want[0] == 200 and want[1].count(b"\n") > 24


@pytest.mark.parametrize("name,host_paths", [
    ("R1", ()), ("R3", ()), ("R4", ()),
    ("R3", ("host_bitmap_rows", "host_rows")), ("R4", ("host_bitmap_rows",))])
def test_a_post_records_its_routes_spans_in_one_request(
        served, monkeypatch, tmp_path, name, host_paths):
    """(b) Under profile_all_threads, a POST on a ThreadingHTTPServer
    thread records every span name its route reaches, all on the handler
    thread inside its one `kaamer.request`; (c) on each thread spans
    nest, and the pipeline's spans and the engine's outer ones are
    children of the request: a batch's results span held open across its
    yield would hold run_search's encoding span, or the next batch's
    phase 1, inside it.  host_paths, the counters that must move besides
    batches and syncs: with the bitmap gate closed, rows' position
    bitmaps come from the host (R3's JSON positions, R4's start-codon
    refinement; host_bitmap_rows); with CAP_MAX at 64 too, R3's heaviest
    rows are counted on the host (host_rows, each under a
    `kaamer.engine.host_count` span)."""
    engine, reqs, _ = served
    if host_paths:
        monkeypatch.setattr(te, "_positions_on_device", lambda *a: False)
    if "host_rows" in host_paths:
        monkeypatch.setattr(te, "CAP_MAX", 64)
    before = dict(engine.stats)
    with Served(engine) as url:
        (status, _), spans = _recorded(
            lambda: _post(url, *reqs[name]), tmp_path)
    assert status == 200
    assert {s[0] for s in spans} == set(SERVED) | (
        {"engine.host_count"} if "host_rows" in host_paths else set())
    (_, tid, r0, r1), = [s for s in spans if s[0] == "request"]
    assert all(s[1] == tid and r0 <= s[2] <= s[3] <= r1 for s in spans)
    parents = _nest(spans)
    assert {p for n, p in parents if n in TOP} == {"request"}
    moved = {k for k in COUNTERS if engine.stats[k] > before[k]}
    assert moved == {"batches", "syncs"} | set(host_paths)


@pytest.mark.parametrize("name", ["R1", "R3", "R4"])
def test_bytes_equal_with_the_profiler_on_and_off(served, tmp_path, name):
    """(d) Protein TSV, JSON with positions and FASTQ lean TSV: the same
    bytes with the profiler on and off."""
    engine, reqs, _ = served
    with Served(engine) as url:
        off = _post(url, *reqs[name])
        on, spans = _recorded(lambda: _post(url, *reqs[name]), tmp_path)
    assert off[0] == 200 and on == off and spans


def test_each_blocking_read_is_one_sync_span_and_one_count(
        served, monkeypatch, tmp_path):
    """(e) dispatch -> schedule -> prefetch -> collect of a hot batch
    whose certificates fail (a cold candidate list of 1, as
    test_torch_positions forces): the `kaamer.engine.sync` spans, the
    reads that count_reads counts and engine.stats["syncs"]'s move are
    one number."""
    engine, _, _ = served
    monkeypatch.setattr(engine, "_k_cold", 1)
    rng = np.random.default_rng(5)
    queries = [(engine.art.sequence(int(rng.integers(
        0, engine.art.num_proteins))) * 4)[:120] for _ in range(48)]
    sizes = [len(q) - 6 for q in queries]
    before = dict(engine.stats)

    def run():
        with count_reads() as n:
            h = engine.dispatch_batch(queries, sizes, k=10, positions=True)
            s = engine.prefetch_batch(engine.schedule_batch(h))
            got = engine.collect_batch(s)
            [qc.offs for qc in got if qc is not None]  # the slice starts
        return n["reads"], got

    (reads, got), spans = _recorded(run, tmp_path)
    assert engine.stats["rerun_rows"] > before["rerun_rows"]
    assert engine.stats["legacy"] > before["legacy"]
    syncs = sum(1 for s in spans if s[0] == "engine.sync")
    assert syncs == reads == engine.stats["syncs"] - before["syncs"] > 3
    _nest(spans)
    assert len(got) == len(queries)


def test_warmup_leaves_the_counters(served):
    """(f) The warmup counts nothing, the new counters included; a batch
    served after it moves batches and syncs."""
    engine, _, queries = served
    before = dict(engine.stats)
    engine.warmup(batch_sizes=(16,), lengths=(16,), positions=(False, True),
                  caps=(te.CAP_MIN,), cap_ts=(0,))
    assert engine.stats == before
    engine.count_batch(queries[:4], [len(q) - 6 for q in queries[:4]], k=10)
    assert engine.stats["batches"] == before["batches"] + 1
    assert engine.stats["syncs"] > before["syncs"]
