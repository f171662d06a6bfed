"""Share (%) of the client-timed request walls spent outside the search
pipeline's run_search: the form upload and parse, the chunked writes of
the answer, the socket and the client."""

from benchmark.metrics._spans import run_search_s


def read(ctx):
    rs = run_search_s(ctx)
    walls = sum(r["t1"] - r["t0"] for r in ctx.records if r["ok"])
    if rs is None or walls <= 0:
        return None
    return 100.0 * (1.0 - rs / walls)
