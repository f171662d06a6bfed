"""Hit counting as sort + run-length encoding, in torch
(kaamer_tpu/ops/count.py).

Protein rows travel as int64 holding the uint32 value; ROW_SENTINEL
(0xFFFFFFFF) is then a large positive number and sorts last, as the
uint32 sentinel does in the JAX package (an int32 view would make it -1
and sort it first).  The resident postings stay int32 views and are
widened after each gather.

Ranking: count descending, ties by lower protein row -- lax.top_k's
lower-index preference over the ascending-row RLE layout, reproduced with
a stable descending sort (torch.topk promises no tie order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec import as_u32

ROW_SENTINEL = 0xFFFFFFFF
_KEY_SENTINEL = torch.iinfo(torch.int64).max


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def dedup_runs(offs: torch.Tensor, lens: torch.Tensor):
    """Query-time KComb (count.py:dedup_runs): collapse consecutive k-mer
    positions that resolved to the same postings slice into one weighted
    expansion unit.

    offs, lens: int64[B, L].  Returns (lens_u, wstart, run_start):
    lens with non-run-start positions zeroed, each run's length in
    positions at its start lane, and each position's run-start lane."""
    B, L = offs.shape
    lane = torch.arange(L, device=offs.device)[None, :]
    diff_prev = offs[:, 1:] != offs[:, :-1]
    edge = torch.ones((B, 1), dtype=torch.bool, device=offs.device)
    is_new = torch.cat([edge, diff_prev], dim=1)
    lens_u = torch.where(is_new, lens, 0)
    change_next = torch.cat([diff_prev, edge], dim=1)
    run_end = _rev_cummin(torch.where(change_next, lane, L))
    wstart = run_end - lane + 1
    run_start = torch.cummax(torch.where(is_new, lane, 0), dim=1).values
    return lens_u, wstart, run_start


def _fold(cum: torch.Tensor, cap: int, values):
    """Map each flat entry j < cap to its run lane seg = sum_l [cum_l <= j]
    and pick each per-lane value at that lane.

    cum is a nondecreasing inclusive cumsum, so seg is a right-sided
    searchsorted.  The JAX package's in_seg mask (count.py:116-134) selects
    exactly lane seg, or no lane when seg == L (past the total); here that
    is one gather instead of a [B, L, cap] compare.  Entries past the total
    pick lane L-1's values, which every caller masks by its valid flags."""
    L = cum.shape[1]
    j = torch.arange(cap, device=cum.device).expand(cum.shape[0], cap)
    seg = torch.searchsorted(cum.contiguous(), j.contiguous(), right=True)
    seg = seg.clamp(max=L - 1)
    return seg, [v.gather(1, seg) for v in values]


def expand_hybrid(postings, offs, cum_s, wstart, cum_t, lens_l,
                  cap_s: int, cap_t: int):
    """Two-tier postings expansion (count.py:expand_hybrid): short runs
    element by element, long runs as the 128-wide postings tiles covering
    them, out-of-run lanes masked to ROW_SENTINEL.

    postings: int32[P] (uint32 rows), P % 128 == 0
    offs, cum_s, wstart, cum_t, lens_l: int64[B, L] phase-1 outputs
    Returns (rows int64[B, cap_s + 128 cap_t], seg int64[...] run-start
    lane of each entry, valid bool[...], w int64[...] entry weights)."""
    B, L = offs.shape
    zero = torch.zeros((B, 1), dtype=cum_s.dtype, device=offs.device)

    # short part: element expansion
    vbase = offs - torch.cat([zero, cum_s[:, :-1]], dim=1)
    seg_s, (base_s, w_s) = _fold(cum_s, cap_s, [vbase, wstart])
    j = torch.arange(cap_s, device=offs.device)[None, :]
    valid_s = j < cum_s[:, -1:]
    src = torch.where(valid_s, base_s + j, 0)
    rows_s = torch.where(valid_s, as_u32(postings[src]), ROW_SENTINEL)
    w_s = torch.where(valid_s, w_s, 0)
    if cap_t == 0:
        return rows_s, seg_s, valid_s, w_s

    # long part: tile-row expansion
    ptiles = postings.reshape(-1, 128)
    tbase = (offs >> 7) - torch.cat([zero, cum_t[:, :-1]], dim=1)
    seg_t, (base_t, off_t, len_t, w_t) = _fold(
        cum_t, cap_t, [tbase, offs, lens_l, wstart])
    jr = torch.arange(cap_t, device=offs.device)[None, :]
    valid_t = jr < cum_t[:, -1:]
    tile = torch.where(valid_t, base_t + jr, 0).clamp(0, ptiles.shape[0] - 1)
    gath = as_u32(ptiles[tile])                            # [B, cap_t, 128]
    a = torch.arange(128, device=offs.device)[None, None, :]
    abs_idx = tile[:, :, None] * 128 + a
    keep = (valid_t[:, :, None]
            & (abs_idx >= off_t[:, :, None])
            & (abs_idx < (off_t + len_t)[:, :, None]))
    rows_t = torch.where(keep, gath, ROW_SENTINEL).reshape(B, cap_t * 128)
    keep_e = keep.reshape(B, cap_t * 128)
    seg_e = seg_t[:, :, None].expand(B, cap_t, 128).reshape(B, -1)
    w_e = torch.where(keep, w_t[:, :, None], 0).reshape(B, -1)

    rows = torch.cat([rows_s, rows_t], dim=1)
    seg = torch.cat([seg_s, seg_e], dim=1)
    valid = torch.cat([valid_s, keep_e], dim=1)
    w = torch.cat([w_s, w_e], dim=1)
    return rows, seg, valid, w


def sort_weighted(rows: torch.Tensor, weights: torch.Tensor):
    """Sort each row's (row, weight) entries by row, then weight, as one
    int64 key (row << 32) | weight: ROW_SENTINEL entries get the largest
    key and sort last, with weight 0.  Returns (s, w) int64[B, n]."""
    key = torch.where(rows == ROW_SENTINEL, _KEY_SENTINEL,
                      (rows << 32) | weights)
    ks = torch.sort(key, dim=1).values
    sent = ks == _KEY_SENTINEL
    return (torch.where(sent, ROW_SENTINEL, ks >> 32),
            torch.where(sent, 0, ks & 0xFFFFFFFF))


def rle_weighted(s: torch.Tensor, w: torch.Tensor):
    """Weighted run-length encoding of sorted rows s: each run's weight sum
    at its start lane, ROW_SENTINEL runs excluded.  Returns (counts
    int64[B, n], is_start bool[B, n]).  The run sums need no gathers:
    each lane backward-fills its run's inclusive-cumsum endpoint (the
    nearest future endpoint is the minimum over future endpoints, since
    the cumsum is nondecreasing)."""
    edge = torch.ones_like(s[:, :1], dtype=torch.bool)
    differs = s[:, 1:] != s[:, :-1]
    is_start = torch.cat([edge, differs], dim=1) & (s != ROW_SENTINEL)
    change_next = torch.cat([differs, edge], dim=1)
    wc = torch.cumsum(w, dim=1)
    wc_end = _rev_cummin(torch.where(change_next, wc, 2**62))
    return torch.where(is_start, wc_end - wc + w, 0), is_start


def sort_rle(rows: torch.Tensor, weights=None):
    """Sort each row multiset and run-length encode it (count.py:sort_rle).

    rows: int64[B, cap] (ROW_SENTINEL padding); weights: optional int64
    per-entry multiplicities.  Returns (s int64[B, cap] sorted rows,
    counts int32[B, cap] with each run's weight sum at its start lane,
    is_start bool[B, cap]; sentinels excluded).

    One path replaces both of the JAX package's weighted branches (the
    packed row << bits | w key and the two-operand sort): with int64 keys,
    (row << 32) | w always fits for rows < 2^31, and since RLE sums the
    weights of a run, the order among equal rows does not change any
    count."""
    if weights is not None:
        s, w = sort_weighted(rows, weights)
        counts, is_start = rle_weighted(s, w)
        return s, counts.to(torch.int32), is_start
    cap = rows.shape[1]
    s = torch.sort(rows, dim=1).values
    idx = torch.arange(cap, device=rows.device)[None, :]
    edge = torch.ones_like(s[:, :1], dtype=torch.bool)
    differs = s[:, 1:] != s[:, :-1]
    is_start = torch.cat([edge, differs], dim=1) & (s != ROW_SENTINEL)
    change_next = torch.cat([differs, edge], dim=1)
    run_end = _rev_cummin(torch.where(change_next, idx, cap))
    counts = torch.where(is_start, run_end - idx + 1, 0)
    return s, counts.to(torch.int32), is_start


def count_topk(rows: torch.Tensor, k: int, weights=None):
    """Sort + RLE + top-k (count, row) pairs (count.py:count_topk).
    Returns (counts int32[B, k], hit_rows int64[B, k]); absent entries have
    count 0 and row ROW_SENTINEL."""
    s, counts, _ = sort_rle(rows, weights)
    top_counts, top_pos = torch.sort(counts, dim=1, descending=True,
                                     stable=True)
    top_counts, top_pos = top_counts[:, :k], top_pos[:, :k]
    hit_rows = torch.where(top_counts > 0, s.gather(1, top_pos), ROW_SENTINEL)
    return top_counts, hit_rows


def expand_run_bitmaps(found_u: torch.Tensor,
                       run_start: torch.Tensor) -> torch.Tensor:
    """Broadcast per-run position bitmaps to every position of the run
    (count.py:expand_run_bitmaps).  found_u: bool[B, K, L] with bits only
    at run-start lanes; run_start: int64[B, L].  The running max of
    2 * run_start + bit keeps the run head's bit along the run and resets
    at the next run, whose run_start is larger."""
    t = run_start[:, None, :] * 2 + found_u.to(run_start.dtype)
    return (torch.cummax(t, dim=2).values & 1).bool()


def member_bitmap_from_rows(rows: torch.Tensor, seg: torch.Tensor,
                            hits: torch.Tensor, L: int) -> torch.Tensor:
    """Position bitmaps from the expanded postings
    (count.py:member_bitmap_from_rows): bitmap[b, k, l] is True iff some
    expanded entry of query b has row hits[b, k] and lane seg == l.

    rows int64[B, cap] (ROW_SENTINEL padding), seg int64[B, cap] run-start
    lane of each entry, hits int64[B, K].  The JAX function is a bf16
    einsum over [B, cap, K] x [B, cap, L] indicators, B * cap * K * L
    multiply-adds for at most B * cap set bits; here each entry finds its
    hit by a binary search in the row's sorted hits and adds one at (hit,
    seg), a scatter of B * cap entries.  Equal hits (only the sentinel
    repeats in a top-k) all get the bits of the first, as in the einsum,
    so the result is the same bool tensor on every input."""
    B, K = hits.shape
    hs, order = torch.sort(hits, dim=1, stable=True)
    pos = torch.searchsorted(hs, rows.contiguous()).clamp(max=K - 1)
    match = (hs.gather(1, pos) == rows) & (seg >= 0) & (seg < L)
    acc = torch.zeros((B, K * L), dtype=torch.int32, device=rows.device)
    acc.scatter_add_(1, pos * L + seg.clamp(0, L - 1), match.to(torch.int32))
    found = acc.view(B, K, L) > 0
    # a repeated hit value takes the bits of its first (sorted) copy
    k = torch.arange(K, device=rows.device)[None, :]
    first = torch.cat([torch.ones_like(hs[:, :1], dtype=torch.bool),
                       hs[:, 1:] != hs[:, :-1]], dim=1)
    head = torch.cummax(torch.where(first, k, 0), dim=1).values
    found = found.gather(1, head[:, :, None].expand(B, K, L))
    # back to the caller's hit order
    return torch.empty_like(found).scatter_(
        1, order[:, :, None].expand(B, K, L), found)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., L] -> uint8[..., L // 8], little-endian, 8 positions a
    byte (count.py:pack_bits; L % 8 == 0); the host inverse is
    np.unpackbits(..., bitorder="little")."""
    shaped = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    w = 1 << torch.arange(8, device=bits.device, dtype=torch.int32)
    return (shaped.to(torch.int32) * w).sum(dim=-1).to(torch.uint8)


def member_np(postings: np.ndarray, offs: np.ndarray, lens: np.ndarray,
              hits: np.ndarray) -> np.ndarray:
    """Host position bitmaps for one query (a copy of
    kaamer_tpu.ops.count.member_np, whose module imports jax): which k-mer
    positions' postings slices contain each hit row.

    postings: uint32[P]; offs/lens: int64[L] per-k-mer slices (sorted rows);
    hits: uint32[K].  Returns bool[K, L] via vectorized binary search."""
    L = offs.shape[0]
    K = hits.shape[0]
    lo = np.broadcast_to(offs[None, :], (K, L)).astype(np.int64).copy()
    hi = (offs + lens)[None, :].astype(np.int64)
    hi = np.broadcast_to(hi, (K, L)).copy()
    h = hits[:, None].astype(np.uint32)
    maxlen = int(lens.max()) if L else 0
    iters = max(1, int(np.ceil(np.log2(maxlen + 1))) + 1) if maxlen > 0 else 0
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = postings[np.clip(mid, 0, max(len(postings) - 1, 0))]
        go_right = active & (v < h)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    in_range = lo < (offs + lens)[None, :]
    found = np.zeros((K, L), dtype=bool)
    if len(postings):
        found = in_range & (postings[np.clip(lo, 0, len(postings) - 1)] == h)
    return found
