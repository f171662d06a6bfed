"""Cuckoo k-mer hash table with inline postings slices.

Replaces the reference's Badger LSM point lookups (kv_store.go:157-204) with
an immutable structure designed for batched TPU probes.  Design driver
(measured, scripts/probe_microbench.py): XLA row-gather cost from HBM is
~12ns fixed + ~0.2ns/byte per row, so a probe's speed is set by HOW MANY and
HOW WIDE the gathered rows are -- not by load factors or probe-loop cleverness
(data-dependent probe loops pay per-iteration launch overhead on TPU and are
ruled out entirely).

Layout: a single array of 2-slot rows, 6 uint32 per row (24 B):

  row r = [key0, start0, len0, key1, start1, len1]

Each key is placed in exactly one slot of row h1(key) or row h2(key)
(2-choice, 2-slot bucketized cuckoo; placement threshold ~0.897, built at
load <= 0.8).  The value is the key's postings slice (start, len) INLINE, so
one lookup = exactly TWO 24 B row-gathers + vectorized compares -- no third
gather through a set-offsets array (which at UniProtKB scale is ~1.6 GB of
HBM on its own).  Versus the previous two-level 8-slot/64 B-bucket design
this halves both probe nanoseconds (2x24 B vs 2x64 B + 8 B rows) and table
bytes (~9 B/key at load 0.75 vs ~18 B/key).

Empty slots have key 0xFFFFFFFF (> any 7-mer code, 22^7-1 = 2.49e9).
Misses report (start=miss_start, len=0): with miss_start = total postings P,
the host can recover a slice's dense set id as
np.searchsorted(set_offsets, start) (set starts are strictly increasing),
with P mapping to the sentinel empty set -- so the device never needs the
set-id indirection but host-side position lookups still have it.

Build: bulk synchronous random-walk insertion, fully vectorized (rounds of
argsort-by-bucket + rank placement + one random kick per contended bucket).
Deterministic via a fixed-seed Generator.  If a build does not converge the
table grows one bit and retries (same policy as the reference-era secondary
growth).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HASH_MULT = np.uint32(0x9E3779B1)     # choice 1: Fibonacci multiplier
HASH_MULT2 = np.uint32(0x85EBCA77)    # choice 2: xxhash-style odd constant

EMPTY_KEY = np.uint32(0xFFFFFFFF)

ROW_U32 = 6      # [k0, s0, l0, k1, s1, l1]
_MAX_ROUNDS = 512


@dataclass
class CuckooTable:
    table: np.ndarray  # uint32[rows, 6]
    log2: int          # rows == 1 << log2

    @property
    def rows(self) -> int:
        return self.table.shape[0]


def bucket_of(keys: np.ndarray, log2: int, mult: np.uint32) -> np.ndarray:
    """Top-bits multiplicative hash into [0, 2^log2)."""
    return ((keys.astype(np.uint32) * mult) >> np.uint32(32 - log2)).astype(
        np.int64)


def _try_build(keys, starts, lens, t: int, rng) -> np.ndarray | None:
    rows = 1 << t
    tk = np.full((rows, 2), EMPTY_KEY, dtype=np.uint32)
    tv = np.zeros((rows, 2, 2), dtype=np.uint32)

    pk = keys.astype(np.uint32, copy=True)
    pv = np.stack([starts.astype(np.uint32), lens.astype(np.uint32)], axis=1)
    side = np.zeros(pk.size, dtype=np.uint8)

    for _ in range(_MAX_ROUNDS):
        if pk.size == 0:
            out = np.empty((rows, ROW_U32), dtype=np.uint32)
            out[:, 0] = tk[:, 0]
            out[:, 1] = tv[:, 0, 0]
            out[:, 2] = tv[:, 0, 1]
            out[:, 3] = tk[:, 1]
            out[:, 4] = tv[:, 1, 0]
            out[:, 5] = tv[:, 1, 1]
            return out

        h = np.where(side == 0, bucket_of(pk, t, HASH_MULT),
                     bucket_of(pk, t, HASH_MULT2))
        order = np.argsort(h, kind="stable")
        hs = h[order]
        first = np.ones(hs.size, dtype=bool)
        first[1:] = hs[1:] != hs[:-1]
        gstart = np.maximum.accumulate(
            np.where(first, np.arange(hs.size), 0))
        rank = np.arange(hs.size) - gstart

        free0 = tk[hs, 0] == EMPTY_KEY
        free1 = tk[hs, 1] == EMPTY_KEY
        nfree = free0.astype(np.int64) + free1
        place = rank < nfree
        # rank 0 takes the first free slot; rank 1 only places when both
        # slots are free, in which case slot 1 is its first free slot
        slot = np.where(rank == 0, np.where(free0, 0, 1), 1)

        pi = order[place]
        tk[hs[place], slot[place]] = pk[pi]
        tv[hs[place], slot[place]] = pv[pi]

        # one evictor per still-contended bucket: after the placements above
        # its bucket is full, so kick a (seeded-)random resident out
        ev = (rank == nfree) & (nfree < 2)
        ei = order[ev]
        eb = hs[ev]
        kick = rng.integers(0, 2, size=eb.size)
        old_k = tk[eb, kick].copy()
        old_v = tv[eb, kick].copy()
        tk[eb, kick] = pk[ei]
        tv[eb, kick] = pv[ei]
        # the evicted key retries at its other candidate bucket
        ev_side = np.where(bucket_of(old_k, t, HASH_MULT) == eb, 1, 0)

        lose = ~place & ~ev
        li = order[lose]
        pk = np.concatenate([pk[li], old_k])
        pv = np.concatenate([pv[li], old_v])
        side = np.concatenate([side[li] ^ 1, ev_side.astype(np.uint8)])
    return None


def build_table(
    keys: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    min_log2: int = 0,
) -> CuckooTable:
    """Build from unique uint32 keys and their (start, len) slice values.
    min_log2 (if given) is a lower bound on the row-count log2 (used to keep
    shards of a sharded index structurally identical)."""
    n = keys.shape[0]
    # 2 slots/row at load <= 0.8  ->  rows >= n / 1.6
    t = max(min_log2, 3,
            int(np.ceil(np.log2(max(n, 2) / 1.6))) if n > 1 else 3)
    while True:
        rng = np.random.default_rng(0xC0FFEE + t)
        table = _try_build(keys, starts, lens, t, rng)
        if table is not None:
            return CuckooTable(table=table, log2=t)
        t += 1  # did not converge -- grow and rebuild


def lookup_np(ht: CuckooTable, queries: np.ndarray,
              miss_start: int) -> "tuple[np.ndarray, np.ndarray]":
    """Host-side reference lookup returning (starts, lens); misses get
    (miss_start, 0).  (Tests/oracle; the serving path is ops/probe.py.)"""
    q = queries.astype(np.uint32)
    starts = np.full(q.shape, miss_start, dtype=np.uint32)
    lens = np.zeros(q.shape, dtype=np.uint32)
    found = np.zeros(q.shape, dtype=bool)
    for mult in (HASH_MULT, HASH_MULT2):
        b = bucket_of(q, ht.log2, mult)
        rows = ht.table[b]  # [..., 6]
        for s0 in (0, 3):
            hit = (~found) & (rows[..., s0] == q)
            starts[hit] = rows[..., s0 + 1][hit]
            lens[hit] = rows[..., s0 + 2][hit]
            found |= hit
    return starts, lens


def occupied_entries(table: np.ndarray):
    """(keys, starts, lens) of every occupied slot of a [rows, 6] table."""
    keys = np.concatenate([table[:, 0], table[:, 3]])
    starts = np.concatenate([table[:, 1], table[:, 4]])
    lens = np.concatenate([table[:, 2], table[:, 5]])
    occ = keys != EMPTY_KEY
    return keys[occ], starts[occ], lens[occ]
