"""Share (%) of run_search's wall inside the engine's host methods
(dispatch, schedule, prefetch, collect, resolve, host bitmaps)."""

from benchmark.metrics._spans import engine_names, run_search_s, seconds


def read(ctx):
    rs = run_search_s(ctx)
    if rs is None:
        return None
    return 100.0 * seconds(ctx.spans, engine_names()) / rs
