"""One reader a metric, `<metric>.py`, found by the metric's name in
BENCHMARK.json; each has `read(ctx)` (see run.Context) and returns the
number, or None where the run has nothing for it to read."""
