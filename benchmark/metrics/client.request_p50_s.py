"""Median client-timed wall of a request in the window, seconds."""

import statistics


def read(ctx):
    walls = [r["t1"] - r["t0"] for r in ctx.records if r["ok"]]
    return statistics.median(walls) if walls else None
