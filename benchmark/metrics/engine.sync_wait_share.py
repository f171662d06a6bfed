"""Share (%) of the requests' time that the engine waited in blocking
device-to-host reads: seconds in `kaamer.engine.sync` spans over seconds
in `kaamer.request` spans, each per thread with overlaps counted once
and summed over threads, within the traced window."""

from benchmark.metrics._idle import program_spans
from benchmark.metrics._spans import seconds


def read(ctx):
    spans = program_spans(ctx.trace)
    req = seconds(spans, {"kaamer.request"})
    if req <= 0:
        return None
    return 100.0 * seconds(spans, {"kaamer.engine.sync"}) / req
