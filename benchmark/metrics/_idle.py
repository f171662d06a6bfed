"""The program's own spans in a traced run, shared by readers: the
`kaamer.` ranges that kaamer_tpu_torch opens itself (its trace.span),
recorded by the profiler on the thread that ran them, on the clock of
the device's operations.

idle_by_span puts each instant of the window in which the card ran
nothing down to one span.  On each thread that instant belongs to the
innermost `kaamer.` span open there (the program's spans nest on a
thread); where several threads have one open, the first in ORDER wins:

  engine.chunk, engine.phase1, engine.host_count, engine.plan,
  engine.sync, engine.schedule (open between its children),
  pipeline.results, request,

and a `kaamer.` span of another name after all of these.  An idle
instant with no `kaamer.` span open on any thread is put down to none.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "kaamer."
ORDER = tuple(PREFIX + n for n in (
    "engine.chunk", "engine.phase1", "engine.host_count", "engine.plan",
    "engine.sync", "engine.schedule", "pipeline.results", "request"))


def program_spans(trace) -> list:
    """The trace's `kaamer.` spans that overlap the window, clipped to it,
    as (name, thread, start ns, end ns, None)."""
    if trace is None:
        return []
    a, b = trace.window
    return [(name, tid, max(t0, a), min(t1, b), None)
            for name, tid, t0, t1, _ in trace.spans
            if name.startswith(PREFIX) and t1 > a and t0 < b]


def count(trace, name: str) -> int:
    """How many `name` spans started in the window."""
    a, b = trace.window
    return sum(1 for s in trace.spans if s[0] == name and a <= s[2] < b)


def _rank(name: str) -> int:
    try:
        return ORDER.index(name)
    except ValueError:
        return len(ORDER)


def _innermost(spans: List[Tuple[int, int, int]]):
    """One thread's (start, end, rank) spans as segments (start, end,
    rank) in which that span is the innermost one open."""
    out = []
    stack = []  # (end, rank) of the open spans, innermost last
    cur = None
    for t0, t1, r in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= t0:
            end, rr = stack.pop()
            if end > cur:
                out.append((cur, end, rr))
                cur = end
        if stack and t0 > cur:
            out.append((cur, t0, stack[-1][1]))
        stack.append((t1, r))
        cur = t0 if cur is None else max(cur, t0)
    while stack:
        end, rr = stack.pop()
        if end > cur:
            out.append((cur, end, rr))
            cur = end
    return out


def _idle_gaps(trace) -> List[Tuple[int, int]]:
    a, b = trace.window
    gaps, prev = [], a
    for s, t in trace.busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if prev < b:
        gaps.append((prev, b))
    return gaps


def idle_by_span(trace) -> Optional[Dict[str, float]]:
    """Seconds of the window in which the card ran nothing, by the span
    they are put down to (the module's rule), or None where the trace
    holds no `kaamer.` span in the window."""
    spans = program_spans(trace)
    if not spans:
        return None
    by_thread = defaultdict(list)
    for name, tid, t0, t1, _ in spans:
        by_thread[tid].append((t0, t1, _rank(name)))
    marks = []
    for v in by_thread.values():
        for s, t, r in _innermost(v):
            marks.append((s, 1, r))
            marks.append((t, -1, r))
    marks.sort()
    names = ORDER + ("",)
    open_ = [0] * len(names)
    segments, last = [], None
    for t, d, r in marks:
        if last is not None and t > last:
            label = next((i for i, c in enumerate(open_) if c > 0), None)
            if label is not None:
                segments.append((last, t, label))
        last = t
        open_[r] += d
    out = defaultdict(float)
    i = 0
    for g0, g1 in _idle_gaps(trace):
        while i < len(segments) and segments[i][1] <= g0:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < g1:
            s0, s1, label = segments[j]
            if min(s1, g1) > max(s0, g0):
                out[names[label]] += (min(s1, g1) - max(s0, g0)) / 1e9
            j += 1
    return out


def idle_share(trace, names) -> Optional[float]:
    """Share (%) of the window in which the card ran nothing and the
    instant is put down to one of the named spans; None without
    `kaamer.` spans."""
    idle = idle_by_span(trace)
    if idle is None or trace.window_s <= 0:
        return None
    return 100.0 * sum(idle.get(PREFIX + n, 0.0) for n in names) \
        / trace.window_s
