"""The hot-set product's share (%) of its roofline: the least time of
every call in the traced window whose kernels the trace shows (_peaks:
the larger of its bytes over the memory bandwidth and its operations over
the bf16 peak, from the call's logical shapes W[G, H] @ M[H, P]) over the
device time of those kernels: every kernel, copy and set that an
operation inside the call's span launched (tracefile.py)."""

from benchmark.metrics._peaks import gemm_cost, least_s


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [(info, ns) for info, ns in ctx.trace.gemm_calls() if ns > 0]
    if not calls:
        return None
    least = sum(least_s(*gemm_cost(**info)) for info, _ in calls)
    return 100.0 * least / (sum(ns for _, ns in calls) / 1e9)
