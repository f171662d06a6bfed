"""Share (%) of the traced window in which the card ran nothing while
the program was enqueueing work for it: idle instants put down to
`kaamer.engine.phase1` (a batch's upload and phase-1 launches) or
`kaamer.engine.chunk` (one phase-2 chunk's index upload, gathers and
launches), by _idle.py's rule."""

from benchmark.metrics._idle import idle_share


def read(ctx):
    return idle_share(ctx.trace, ("engine.phase1", "engine.chunk"))
