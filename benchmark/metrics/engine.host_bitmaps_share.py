"""Share (%) of run_search's wall in the engine's position_bitmaps_np:
k-mer position bitmaps worked out on the host for the batches whose
bitmaps the gate (_positions_on_device) kept off the device."""

from benchmark.metrics._spans import run_search_s, seconds


def read(ctx):
    rs = run_search_s(ctx)
    if rs is None:
        return None
    return 100.0 * seconds(ctx.spans, {"engine.position_bitmaps_np"}) / rs
