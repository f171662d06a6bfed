"""Batched cuckoo-table probe in torch (kaamer_tpu/ops/probe.py).

Two row gathers per k-mer, one per hash choice, and a masked sum of the
matching slot's (start, len): the same static-shape probe as the JAX
package, on the same [rows, 6] table (index/hashtable.py).
"""

from __future__ import annotations

import torch

from ..codec import U32, as_u32
from ..index.hashtable import HASH_MULT, HASH_MULT2


def hash_bucket(q: torch.Tensor, mult: int, log2: int) -> torch.Tensor:
    """(q * mult mod 2^32) >> (32 - log2) for int64 q < 2^32.

    q * mult can reach 2^64 and overflow int64, so q is split into 16-bit
    halves: only the low 16 bits of q_hi * mult survive the << 16 mod 2^32."""
    q_lo = q & 0xFFFF
    q_hi = q >> 16
    h = (q_lo * mult + (((q_hi * mult) & 0xFFFF) << 16)) & U32
    return h >> (32 - log2)


def probe_slices(table: torch.Tensor, queries: torch.Tensor, log2: int,
                 miss_start: int):
    """Postings slice of each k-mer code.

    table:   int32[rows, 6] holding the uint32 [k0, s0, l0, k1, s1, l1] rows
    queries: int64[...] k-mer codes (< 2^32 - 1)
    returns: (starts int64[...], lens int64[...]); misses get
             (miss_start, 0).

    Each key sits in exactly one slot of its two candidate rows; when
    h1(q) == h2(q) the same row is gathered twice, so each check masks out
    lanes already found."""
    shape = queries.shape
    q = queries.reshape(-1)
    start_acc = torch.zeros_like(q)
    len_acc = torch.zeros_like(q)
    found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    for mult in (int(HASH_MULT), int(HASH_MULT2)):
        rows = as_u32(table[hash_bucket(q, mult, log2)])  # [n, 6]
        for s0 in (0, 3):
            hit = (rows[:, s0] == q) & ~found
            start_acc = start_acc + torch.where(hit, rows[:, s0 + 1], 0)
            len_acc = len_acc + torch.where(hit, rows[:, s0 + 2], 0)
            found = found | hit
    starts = torch.where(found, start_acc, miss_start)
    return starts.reshape(shape), len_acc.reshape(shape)
