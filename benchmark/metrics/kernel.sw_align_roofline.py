"""The Smith-Waterman kernel's share (%) of its roofline: the least time
of every launch in the traced window (_sw_peaks.sw_cost, from the real
cells and bytes that the program's `kaamer.align.kernel:<cells>:<padded>:
<bytes>` span carries in its name) over the device time of the kernels
those launches ran, `sw_align_kernel` by name in the device's trace (the
one kernel the span's call launches).  Cells a launch pads (rows past a
query's end up to its R) lower the share."""

from benchmark.metrics._sw_peaks import sw_cost

SPAN = "kaamer.align.kernel:"
KERNEL = "sw_align_kernel"


def launches(trace):
    """(cells, padded cells, bytes) of each launch whose span opened in
    the window."""
    a, b = trace.window
    out = []
    for name, _, t0, _, _ in trace.spans:
        if name.startswith(SPAN) and a <= t0 < b:
            cells, padded, nbytes = (int(x) for x in
                                     name[len(SPAN):].split(":"))
            out.append((cells, padded, nbytes))
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    found = launches(ctx.trace)
    a, b = ctx.trace.window
    device_ns = sum(t1 - t0 for t0, t1, name in ctx.trace.device
                    if KERNEL in name and a <= t0 < b)
    if not found or device_ns <= 0:
        return None
    least = sum(sw_cost(cells, nbytes) for cells, _, nbytes in found)
    return 100.0 * least / (device_ns / 1e9)
