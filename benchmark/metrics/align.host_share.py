"""Share (%) of the requests' time that the alignment step took: seconds
in `kaamer.align.dispatch` (a flush's pairs, packing, uploads, launches)
and `kaamer.align.resolve` spans (device reads, each pair's fields, the
re-sort) over seconds in `kaamer.request` spans, each per thread with
overlaps counted once and summed over threads, within the traced
window."""

from benchmark.metrics._idle import program_spans
from benchmark.metrics._spans import seconds

STEPS = {"kaamer.align.dispatch", "kaamer.align.resolve"}


def read(ctx):
    spans = program_spans(ctx.trace)
    req = seconds(spans, {"kaamer.request"})
    step = seconds(spans, STEPS)
    if req <= 0 or step <= 0:
        return None
    return 100.0 * step / req
