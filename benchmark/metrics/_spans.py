"""Sums over the spans of a traced run (spans.py), shared by readers."""

from __future__ import annotations

from collections import defaultdict


def seconds(spans, names) -> float:
    """Seconds covered by the named spans, per thread with overlaps (a
    method calling another) counted once, summed over threads."""
    by = defaultdict(list)
    for name, tid, t0, t1, _ in spans:
        if name in names:
            by[tid].append((t0, t1))
    total = 0
    for v in by.values():
        end = None
        for a, b in sorted(v):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
    return total / 1e9


def engine_names():
    from benchmark.spans import ENGINE_METHODS
    return {f"engine.{m}" for m in ENGINE_METHODS}


def run_search_s(ctx):
    """The run_search steps' seconds, or None without spans."""
    if not ctx.spans:
        return None
    s = seconds(ctx.spans, {"run_search"})
    return s or None
