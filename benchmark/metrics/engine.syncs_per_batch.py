"""Blocking device-to-host reads a batch: `kaamer.engine.sync` spans
over `kaamer.engine.phase1` spans (one a dispatched batch), of those
that started in the traced window."""

from benchmark.metrics._idle import count


def read(ctx):
    if ctx.trace is None:
        return None
    batches = count(ctx.trace, "kaamer.engine.phase1")
    if not batches:
        return None
    return count(ctx.trace, "kaamer.engine.sync") / batches
