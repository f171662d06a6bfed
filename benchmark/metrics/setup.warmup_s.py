"""Seconds of the engine's warmup over the cell's own batch sizes,
lengths and positions flags."""


def read(ctx):
    return ctx.setup["warmup_s"]
