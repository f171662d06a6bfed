"""Seconds of the program's load_engine: the artifact opened and the
index, hot sets and membership matrices put on the card."""


def read(ctx):
    return ctx.setup["load_s"]
