"""Reduction of a traced run: the profiler's Chrome trace, in which the
harness's window, the benchmark's spans (spans.py), the operations of
every thread and the device's kernels, copies and sets share one clock.

A span is (name, thread, start ns, end ns, info): the trace's
record_function ranges, with a hot-set product's shapes as info.  A
kernel is the hot-set product's where the innermost range or operation
open when it was launched (the trace's `External id`, on the kernel or
on its launch) began inside a `hot_matmul#<i>` span on the same thread.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

from .spans import GEMM

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OP_CATS = ("cpu_op", "user_annotation")

# what the host was doing, most specific first (idle_gaps)
HOST_LABELS = tuple(f"engine.{m}" for m in (
    "position_bitmaps_np", "dispatch_batch", "schedule_batch",
    "prefetch_batch", "collect_batch", "resolve_batch")) + (
    "run_search", "do_POST")
LABEL_NAMES = {"run_search": "pipeline.host", "do_POST": "server.http"}
IDLE_NONE = "no_request"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def _ns(us) -> int:
    return int(round(float(us) * 1000))


class Trace:
    def __init__(self, path: str, calls: Dict[int, dict] = None):
        """calls: the hot-set product's shapes by call (spans.Spans)."""
        calls = calls or {}
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        self.spans = []
        ops = {}
        launch_ext = {}
        for e in events:
            cat, args = e.get("cat"), e.get("args", {})
            if cat in OP_CATS:
                t0 = _ns(e["ts"])
                if args.get("External id") is not None:
                    ops[args["External id"]] = (e.get("tid"), t0)
                if cat == "user_annotation":
                    name, _, i = e["name"].partition("#")
                    info = calls.get(int(i)) if name == GEMM and i else None
                    self.spans.append((name, e.get("tid"), t0,
                                       t0 + _ns(e.get("dur", 0)), info))
            elif cat in LAUNCH_CATS and args.get("External id") is not None:
                launch_ext[args.get("correlation")] = args["External id"]
        windows = [s for s in self.spans if s[0] == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} "
                             f"{WINDOW!r} ranges, not one")
        self.window = windows[0][2:4]
        gemm_of = defaultdict(list)  # tid: sorted (start, end, call)
        for k, s in enumerate(self.spans):
            if s[0] == GEMM and s[4] is not None:
                gemm_of[s[1]].append((s[2], s[3], k))
        for v in gemm_of.values():
            v.sort()
        self.device: List[Tuple[int, int, str]] = []
        self.gemm_ns: Dict[int, int] = defaultdict(int)  # by span
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            t0, dur = _ns(e["ts"]), _ns(e.get("dur", 0))
            self.device.append((t0, t0 + dur, e.get("name", "")))
            args = e.get("args", {})
            ext = args.get("External id") or launch_ext.get(
                args.get("correlation"))
            if ext not in ops:
                continue
            tid, at = ops[ext]
            v = gemm_of.get(tid, ())
            j = bisect.bisect_right(v, (at, float("inf"), 0)) - 1
            if j >= 0 and v[j][0] <= at <= v[j][1]:
                self.gemm_ns[v[j][2]] += dur
        a, b = self.window
        self.busy = _union([(max(s, a), min(t, b)) for s, t, _ in self.device
                            if t > a and s < b])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return _length(self.busy) / 1e9

    def gemm_calls(self):
        """(info, device ns) of every hot-set product call in the trace;
        device ns is 0 where no kernel of the call was found."""
        return [(s[4], self.gemm_ns.get(k, 0))
                for k, s in enumerate(self.spans)
                if s[0] == GEMM and s[4] is not None]

    def device_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time, [name, seconds]."""
        a, b = self.window
        by = defaultdict(int)
        for s, t, name in self.device:
            if t > a and s < b:
                by[name[:96]] += t - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Seconds of the window in which the device ran nothing, by what
        the host was doing then (the most specific span open on any
        thread, HOST_LABELS order), [label, seconds], longest first."""
        a, b = self.window
        gaps, prev = [], a
        for s, t in self.busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if prev < b:
            gaps.append((prev, b))
        rank = {k: i for i, k in enumerate(HOST_LABELS)}
        marks = []
        for name, _, t0, t1, _ in self.spans:
            if name in rank and t1 > a and t0 < b:
                marks.append((max(t0, a), 1, rank[name]))
                marks.append((min(t1, b), -1, rank[name]))
        marks.sort()
        segments, open_ = [], [0] * len(HOST_LABELS)
        last = a
        for t, d, r in marks:
            if t > last:
                segments.append((last, t, self._label(open_)))
                last = t
            open_[r] += d
        segments.append((last, b, self._label(open_)))
        out = defaultdict(int)
        i = 0
        for g0, g1 in gaps:
            while i < len(segments) and segments[i][1] <= g0:
                i += 1
            j = i
            while j < len(segments) and segments[j][0] < g1:
                s0, s1, label = segments[j]
                out[label] += min(s1, g1) - max(s0, g0)
                j += 1
        top = sorted(out.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top if v > 0]

    @staticmethod
    def _label(open_) -> str:
        for r, c in enumerate(open_):
            if c > 0:
                name = HOST_LABELS[r]
                return LABEL_NAMES.get(name, name)
        return IDLE_NONE
