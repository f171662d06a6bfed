"""Device side of the 7-mer codec in torch (kaamer_tpu/codec.py).

The host packers of kaamer_tpu.codec (pack_codes7, pad_codes_batch) and
the native packer stay the wire format; this module unpacks the wire words
and encodes 7-mers on the device.

torch has no unsigned 32-bit arithmetic on the CPU (no // or << on uint32),
so words and k-mer codes are carried in int64 holding the unsigned value.
"""

from __future__ import annotations

import torch

from kaamer_tpu.codec import N_AA, PAD3

U32 = 0xFFFFFFFF


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """Widen an int32 tensor holding uint32 bit patterns to int64 values."""
    return words.to(torch.int64) & U32


def unpack_codes7(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of kaamer_tpu.codec.pack_codes7 (unpack_codes7_jnp):
    int32[B, ceil(W/7)] holding uint32 words -> int64[B, width] residue
    codes, -1 for padding.  Base-22 digits, most significant first."""
    p = as_u32(packed)
    digits = [p // 22**6]
    for k in range(5, 0, -1):
        digits.append((p // 22**k) % 22)
    digits.append(p % 22)
    c = torch.stack(digits, dim=-1).reshape(p.shape[0], -1)[:, :width]
    return torch.where(c == PAD3, -1, c)


def encode_kmers(codes: torch.Tensor, n_kmers: int) -> torch.Tensor:
    """encode_kmers_jnp over a batch: codes int64[B, >= n_kmers + 6] ->
    int64[B, n_kmers] 7-mer codes (< 2^32).  A pair holding a code < 0
    encodes as 0 and so does a final residue < 0, as in the reference."""

    def pair(a, b):
        return torch.where((a >= 0) & (b >= 0), 22 + a * N_AA + b, 0)

    n = n_kmers
    p1 = pair(codes[:, 0:n], codes[:, 1:n + 1])
    p2 = pair(codes[:, 2:n + 2], codes[:, 3:n + 3])
    p3 = pair(codes[:, 4:n + 4], codes[:, 5:n + 5])
    last = codes[:, 6:n + 6].clamp(min=0)
    return (p1 << 23) | (p2 << 14) | (p3 << 5) | last

