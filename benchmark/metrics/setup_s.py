"""Seconds from the process's start to the window's opening: the
database opened onto the card, the cell's warmup, the server started and
each client's unmeasured request answered."""


def read(ctx):
    return ctx.setup["setup_s"]
