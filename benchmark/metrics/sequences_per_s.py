"""Query sequences (proteins, reads or contigs) answered a second: those
of every whole answer in the window, over the window, which opens when
set-up ends and closes when the last request sent before --seconds had
passed is answered."""


def read(ctx):
    n = sum(r["n"] for r in ctx.records if r["ok"])
    return n / (ctx.window[1] - ctx.window[0])
