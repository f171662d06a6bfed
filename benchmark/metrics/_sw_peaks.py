"""The least time of a Smith-Waterman launch (csrc/swalign.cu
sw_align_kernel) on the card: the larger of its operations over the
card's int32 rate and its bytes over the memory bandwidth.

About 17 int32 operations a cell of the recurrence (the kernel's design
note), over the pairs' own cells, qlen * rlen each; the int32 rate is the
H100's 132 SMs x 64 int32 lanes x 1.98 GHz.  The bytes are the launch's
inputs read once and its outputs written once."""

from __future__ import annotations

from benchmark.metrics._peaks import HBM_BYTES_PER_S

INT32_OPS_PER_S = 16.7e12
OPS_PER_CELL = 17


def sw_cost(cells: int, nbytes: int = 0) -> float:
    """Seconds: the least time of a launch of `cells` real cells moving
    `nbytes` bytes."""
    return max(OPS_PER_CELL * cells / INT32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)
