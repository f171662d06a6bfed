"""Share (%) of run_search's wall outside the engine's host methods:
reading the upload, the ORF scan, batching, filtering, start-codon
refinement and writing rows."""

from benchmark.metrics._spans import engine_names, run_search_s, seconds


def read(ctx):
    rs = run_search_s(ctx)
    if rs is None:
        return None
    return 100.0 * (rs - seconds(ctx.spans, engine_names())) / rs
