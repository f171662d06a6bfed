"""The trace reduction on a hand-made Chrome trace: the window, busy time,
the kernels launched inside each hot-set product's span, idle gaps by
host activity, and the roofline reader."""

import json

from benchmark.metrics._peaks import gemm_cost, least_s
from benchmark.registry import reader
from benchmark.tracefile import WINDOW, Trace

INFO = {"G": 256, "H": 1024, "P": 1 << 20, "w": 2, "m": 2, "out": 4}


def ev(cat, name, ts_us, dur_us, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "pid": 1, "tid": tid, "args": args}


def make(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def ann(name, ts, dur, tid, ext):
    return ev("user_annotation", name, ts, dur, tid=tid,
              **{"External id": ext})


def events():
    return [
        ann(WINDOW, 0, 1000, tid=1, ext=1),
        ann("do_POST", 0, 900, tid=7, ext=2),
        ann("run_search", 50, 750, tid=7, ext=3),
        ann("engine.schedule_batch", 400, 100, tid=7, ext=4),
        ann("hot_matmul#0", 90, 110, tid=7, ext=5),
        ev("cpu_op", "aten::mm", 100, 10, tid=7, **{"External id": 6}),
        # one gemm names the hot_matmul range it was launched in, the
        # other an operation inside it; the sort's launch names an
        # operation on thread 8, outside any hot_matmul span
        ev("kernel", "gemm", 110, 50, tid=20, correlation=1,
           **{"External id": 5}),
        ev("kernel", "gemm", 165, 5, tid=20, correlation=4,
           **{"External id": 6}),
        ev("cpu_op", "aten::sort", 110, 5, tid=8, **{"External id": 9}),
        ev("cuda_runtime", "cudaLaunchKernel", 111, 2, tid=99, correlation=2,
           **{"External id": 9}),
        ev("kernel", "sort", 310, 40, tid=20, correlation=2),
        ev("kernel", "sort", 340, 20, tid=20, correlation=3),
        # a call on another thread whose kernel the trace does not show
        ann("hot_matmul#1", 600, 10, tid=8, ext=10),
    ]


def test_window_busy_gemm_kernels_and_gaps(tmp_path):
    t = Trace(make(tmp_path, events()), {0: INFO, 1: dict(INFO, G=8)})
    assert t.window == (0, 1_000_000)
    assert t.window_s == 1e-3
    assert abs(t.busy_s - 105e-6) < 1e-12
    assert t.device_ops() == [["sort", 60e-6], ["gemm", 55e-6]]
    assert t.gemm_calls() == [(INFO, 55_000), (dict(INFO, G=8), 0)]
    gaps = dict(map(tuple, t.idle_gaps()))
    # busy: 110-160, 165-170 and 310-360
    assert abs(gaps["engine.schedule_batch"] - 100e-6) < 1e-12
    assert abs(gaps["pipeline.host"] - (60 + 5 + 140 + 40 + 300) * 1e-6) < 1e-9
    assert abs(gaps["server.http"] - (50 + 100) * 1e-6) < 1e-9
    assert abs(gaps["no_request"] - 100e-6) < 1e-9


def test_a_trace_needs_one_window(tmp_path):
    import pytest

    with pytest.raises(ValueError):
        Trace(make(tmp_path, events()[1:]))


def test_roofline_reader(tmp_path):
    class Ctx:
        trace = Trace(make(tmp_path, events()), {0: INFO, 1: INFO})

    # the call whose kernels are not in the trace counts on neither side
    want = 100 * least_s(*gemm_cost(**INFO)) / 55e-6
    assert abs(reader("kernel.hot_gemm_roofline")(Ctx) - want) < 1e-9
    Ctx.trace = Trace(make(tmp_path, events()[:4]))
    assert reader("kernel.hot_gemm_roofline")(Ctx) is None
