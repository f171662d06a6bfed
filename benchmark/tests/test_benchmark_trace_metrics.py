"""The readers of the program's own `kaamer.` spans (metrics/_idle.py and
the six metrics on it) on a hand-made Chrome trace with known busy
intervals and spans on two threads, and on traced CPU runs of the
harness."""

import json
import shutil

import pytest

from benchmark import registry
from benchmark.metrics import _idle
from benchmark.run import Context
from benchmark.tracefile import WINDOW, Trace

from .conftest import BENCH, DATA, TRAFFIC, last_json, run_cell

METRICS = ("engine.launch_idle_share", "engine.plan_idle_share",
           "engine.sync_wait_share", "engine.syncs_per_batch",
           "engine.chunks_per_batch", "pipeline.results_idle_share")


def ann(name, ts, dur, tid):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid, "args": {}}


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "pid": 1, "tid": 20, "args": {}}


def k(name):
    return "kaamer." + name


# window 0-1000 us; the card busy 100-200 and 600-700, idle 800 us.
# Thread 7 plans, counts a row on the host, enqueues two chunks and
# builds results; thread 8 runs phase 1 and waits in a read meanwhile.
# Expected idle by span, us (the module's rule): request 300, chunk 150,
# results 160, sync 60, schedule 50, phase1 30, host_count 30, plan 20.
SPANS = [
    ann(WINDOW, 0, 1000, 1),
    ann(k("request"), 0, 900, 7),
    ann(k("engine.schedule"), 100, 400, 7),
    ann(k("engine.sync"), 100, 50, 7),
    ann(k("engine.plan"), 150, 150, 7),
    ann(k("engine.host_count"), 200, 50, 7),
    ann(k("engine.sync"), 210, 20, 7),
    ann(k("engine.chunk"), 300, 100, 7),
    ann(k("engine.chunk"), 400, 50, 7),
    ann(k("pipeline.results"), 500, 300, 7),
    ann(k("request"), 0, 1000, 8),
    ann(k("engine.phase1"), 250, 30, 8),
    ann(k("engine.sync"), 720, 40, 8),
    # the benchmark's own range, not the program's: read by no reader
    ann("engine.schedule_batch", 0, 1000, 9),
    kernel(100, 100),
    kernel(600, 100),
]
WANT_IDLE = {"request": 300, "engine.chunk": 150, "pipeline.results": 160,
             "engine.sync": 60, "engine.schedule": 50, "engine.phase1": 30,
             "engine.host_count": 30, "engine.plan": 20}


def trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def ctx(t):
    return Context(None, [], (0.0, 1.0), {}, t.spans if t else None, t)


def test_idle_by_span_follows_the_order(tmp_path):
    t = trace(tmp_path, SPANS)
    got = _idle.idle_by_span(t)
    assert set(got) == {k(n) for n in WANT_IDLE}
    for name, us in WANT_IDLE.items():
        assert abs(got[k(name)] - us * 1e-6) < 1e-12, name
    assert abs(sum(got.values()) - (t.window_s - t.busy_s)) < 1e-12


@pytest.mark.parametrize("metric,want", [
    ("engine.launch_idle_share", 18.0),        # (phase1 30 + chunk 150)/1000
    ("engine.plan_idle_share", 5.0),           # (plan 20 + host_count 30)
    ("pipeline.results_idle_share", 16.0),
    ("engine.sync_wait_share", 100 * 110 / 1900),  # sync 70 + 40 us
    ("engine.syncs_per_batch", 3.0),
    ("engine.chunks_per_batch", 2.0),
])
def test_readers_on_a_known_trace(tmp_path, metric, want):
    assert abs(registry.reader(metric)(ctx(trace(tmp_path, SPANS)))
               - want) < 1e-9


def test_another_thread_wins_by_the_order(tmp_path):
    """An instant where one thread plans and another is in phase 1 is
    phase 1's; where one thread is in an unlisted `kaamer.` span and
    another in a request, the request's; with no span open, no one's."""
    t = trace(tmp_path, [
        ann(WINDOW, 0, 100, 1),
        ann(k("engine.plan"), 0, 40, 7),
        ann(k("engine.phase1"), 10, 20, 8),
        ann(k("request"), 50, 30, 8),
        ann(k("something.new"), 50, 10, 7),
    ])
    got = _idle.idle_by_span(t)
    assert abs(got[k("engine.plan")] - 20e-6) < 1e-12
    assert abs(got[k("engine.phase1")] - 20e-6) < 1e-12
    assert abs(got[k("request")] - 30e-6) < 1e-12
    assert abs(sum(got.values()) - 70e-6) < 1e-12


def test_spans_are_clipped_to_the_window(tmp_path):
    t = trace(tmp_path, [
        ann(WINDOW, 100, 100, 1),
        ann(k("engine.chunk"), 0, 150, 7),
        ann(k("engine.phase1"), 50, 10, 8),
        ann(k("engine.phase1"), 160, 10, 8),
        ann(k("engine.chunk"), 190, 50, 7),
    ])
    got = _idle.idle_by_span(t)
    assert abs(got[k("engine.chunk")] - 60e-6) < 1e-12
    assert abs(got[k("engine.phase1")] - 10e-6) < 1e-12
    # one phase 1 and one chunk started in the window
    assert registry.reader("engine.chunks_per_batch")(ctx(t)) == 1.0


@pytest.mark.parametrize("metric", METRICS)
def test_none_without_the_programs_spans(tmp_path, metric):
    """A program that opens no `kaamer.` span (the parent of this
    change), and an untraced run, read nothing."""
    bare = [e for e in SPANS if not e["name"].startswith("kaamer.")]
    assert registry.reader(metric)(ctx(trace(tmp_path, bare))) is None
    assert registry.reader(metric)(ctx(None)) is None


@pytest.fixture(scope="module")
def bench_with_metrics(tmp_path_factory):
    """The tests' benchmark file with the six metrics listed for both of
    its cells."""
    d = tmp_path_factory.mktemp("bench")
    shutil.copytree(DATA + "/configs", d / "configs")
    with open(BENCH) as f:
        b = json.load(f)
    for name in METRICS:
        b["per_layer"].append({
            "name": name, "unit": "%", "better": "lower",
            "source": "program_span", "layer": "engine host",
            "moves": "sequences_per_s",
            "workloads": ["tiny-proteome", "tiny-reads"]})
    (d / "bench.json").write_text(json.dumps(b))
    return str(d / "bench.json")


@pytest.mark.parametrize("workload", ["tiny-proteome", "tiny-reads"])
def test_a_traced_run_reads_the_programs_spans(cache_root, tiny_db,
                                               bench_with_metrics, workload):
    rc, out, err = run_cell(workload, 2**31 + 7, cache_root, trace=1,
                            bench=bench_with_metrics, traffic=TRAFFIC)
    assert rc == 0, "\n".join(err[-30:])
    got = last_json(out)["metrics"]
    for name in METRICS:
        assert got[name]["value"] >= 0, name
    # every batch reads its totals: at least one read a batch
    assert got["engine.syncs_per_batch"]["value"] >= 1
    assert got["engine.chunks_per_batch"]["value"] >= 1
