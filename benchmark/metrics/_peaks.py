"""Peaks of the card and the operation and byte counts of the kernels
whose roofline shares the benchmark reports.

NVIDIA H100 SXM (80 GB HBM3), dense rates without sparsity, at its full
700 W power limit (NVIDIA's data sheet); a card set below that limit runs
slower under load, so each traced run prints its card's power limit."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def gemm_cost(G: int, H: int, P: int, w: int, m: int, out: int):
    """(flops, bytes) of the hot-set product W[G, H] @ M[H, P]: one
    multiply and one add per term, each input byte read once and each
    output byte written once (w, m, out: element sizes in bytes)."""
    return 2 * G * H * P, G * H * w + H * P * m + G * P * out


def least_s(flops: int, nbytes: int, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
