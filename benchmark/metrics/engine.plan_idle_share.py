"""Share (%) of the traced window in which the card ran nothing while
the host planned a batch's phase 2: idle instants put down to
`kaamer.engine.plan` (schedule_batch's planner, after the totals read)
or `kaamer.engine.host_count` (a row past CAP_MAX counted on the host),
by _idle.py's rule."""

from benchmark.metrics._idle import idle_share


def read(ctx):
    return idle_share(ctx.trace, ("engine.plan", "engine.host_count"))
