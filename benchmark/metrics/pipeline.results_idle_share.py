"""Share (%) of the traced window in which the card ran nothing while
the pipeline turned a batch's counts into its results and rows: idle
instants put down to `kaamer.pipeline.results`, by _idle.py's rule."""

from benchmark.metrics._idle import idle_share


def read(ctx):
    return idle_share(ctx.trace, ("pipeline.results",))
