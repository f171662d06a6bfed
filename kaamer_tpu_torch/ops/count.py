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

The weighted count after the sort is one hand-written CUDA kernel,
rle_sorted (csrc/rle.cu); rle_sorted_plain is its plain torch version, the
CPU path and the kernel's oracle.  A CUDA tensor always takes the kernel.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..codec import as_u32
from . import _kernels

ROW_SENTINEL = 0xFFFFFFFF
_KEY_SENTINEL = torch.iinfo(torch.int64).max

# kernel launches: "rle_sorted" those the wrapper made (not counting
# plain-version calls or calls recorded into a CUDA graph), and
# "rle_sorted_replayed" those that replayed CUDA graphs ran, as many as
# were recorded into the graph when it was captured (count_replayed); the
# same launches by the thread that made them (thread_launches), and those
# it recorded into graphs (thread_recorded)
launches = {"rle_sorted": 0, "rle_sorted_replayed": 0}
_launch_lock = threading.Lock()
_thread = threading.local()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def thread_launches() -> int:
    """rle_sorted kernel launches run so far for the calling thread, its
    graph replays' included."""
    return getattr(_thread, "launches", 0)


def thread_recorded() -> int:
    """rle_sorted calls the calling thread recorded into CUDA graphs."""
    return getattr(_thread, "recorded", 0)


def count_replayed(n: int) -> None:
    """Count a replayed CUDA graph's n rle_sorted launches (those recorded
    when it was captured), on the calling thread too."""
    with _launch_lock:
        launches["rle_sorted_replayed"] += n
    _thread.launches = thread_launches() + n


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


def gather_postings(postings, offs, cum, total, cap: int, wstart=None):
    """Expand per-k-mer postings slices into a dense [B, cap] row multiset
    (count.py:gather_postings), the single-tier expansion of the
    whole-batch sharded search.

    postings: int32[P] (uint32 rows), any length P > 0
    offs:     int64[B, L] start offset of each lane's postings slice
    cum:      int64[B, L] inclusive cumsum of the slice lengths
    total:    int64[B]    entries per query that are valid (the JAX
              contract takes it apart from cum[:, -1])
    wstart:   optional int64[B, L] run weights (dedup_runs); when given,
              each entry's weight comes back as a 4th output.
    Returns (rows int64[B, cap], seg int64[B, cap] lane of each entry,
    clamped to L-1, valid bool[B, cap][, w int64[B, cap]]); rows past
    `total` are ROW_SENTINEL, and so is a read past the postings (the fill
    of jnp.take).

    Each entry j finds its lane seg = sum_l [cum_l <= j] by a right-sided
    searchsorted, as _fold does, where the JAX function builds a
    [B, L, chunk] comparison for the TPU's vector unit.  The lane's
    exclusive start is cum at seg - 1 (0 for lane 0), and an entry past
    cum[:, -1] (seg == L) has weight 0, as the JAX masks give."""
    B, L = offs.shape
    P = postings.shape[0]
    j = torch.arange(cap, device=offs.device).expand(B, cap).contiguous()
    seg = torch.searchsorted(cum.contiguous(), j, right=True)
    seg_cl = seg.clamp(max=L - 1)
    prev = torch.where(seg > 0, cum.gather(1, (seg - 1).clamp(min=0)), 0)
    src = offs.gather(1, seg_cl) + (j - prev)
    valid = j < total[:, None]
    src = torch.where(valid, src, 0)
    inside = src < P
    rows = torch.where(valid & inside, as_u32(postings[src.clamp(max=P - 1)]),
                       ROW_SENTINEL)
    if wstart is None:
        return rows, seg_cl, valid
    w = torch.where(valid & (seg < L), wstart.gather(1, seg_cl), 0)
    return rows, seg_cl, valid, w


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


def sort_weighted(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Sort each row's (row, weight) entries by row, then weight, as one
    int64 key (row << 32) | weight: ROW_SENTINEL entries get the largest
    key (_KEY_SENTINEL) and sort last.  Returns the sorted keys int64[B, n],
    which rle_sorted counts."""
    key = torch.where(rows == ROW_SENTINEL, _KEY_SENTINEL,
                      (rows << 32) | weights)
    return torch.sort(key, dim=1).values


def rle_sorted_plain(ks: torch.Tensor, rank_keys: bool = False,
                     skip_inj: bool = False):
    """rle_sorted's plain torch version: the keys unpacked, then the
    weighted run-length encoding.  The run sums need no gathers: each lane
    backward-fills its run's inclusive-cumsum endpoint (the nearest future
    endpoint is the minimum over future endpoints, since the cumsum is
    nondecreasing)."""
    sent = ks == _KEY_SENTINEL
    s = torch.where(sent, ROW_SENTINEL, ks >> 32)
    w = torch.where(sent, 0, ks & 0xFFFFFFFF)
    edge = torch.ones_like(s[:, :1], dtype=torch.bool)
    differs = s[:, 1:] != s[:, :-1]
    is_start = torch.cat([edge, differs], dim=1) & (s != ROW_SENTINEL)
    change_next = torch.cat([differs, edge], dim=1)
    wc = torch.cumsum(w, dim=1)
    wc_end = _rev_cummin(torch.where(change_next, wc, 2**62))
    counts = torch.where(is_start, wc_end - wc + w, 0)
    inj = is_start & (w == 0)
    if not rank_keys:
        return s, counts.to(torch.int32), is_start, inj
    hkey = torch.where(inj, (s << 32) | counts, _KEY_SENTINEL)
    pop = is_start & (counts > 0)
    if skip_inj:
        pop = pop & ~inj
    ckey = torch.where(pop, (-counts << 32) | s, _KEY_SENTINEL)
    return hkey, ckey


def rle_sorted(ks: torch.Tensor, rank_keys: bool = False,
               skip_inj: bool = False):
    """Weighted run-length encoding of sort_weighted's keys.

    ks: int64[G, n], contiguous, each row ascending; a real entry's key is
    (row << 32) | weight (row < 2^31 - 1), _KEY_SENTINEL past them.  A run
    is a stretch of equal rows inside one row of ks; sentinel runs are
    excluded.  Returns (s int64[G, n] the rows, ROW_SENTINEL for a
    sentinel; counts int32[G, n] each run's weight sum at its head lane, 0
    elsewhere; is_start bool[G, n] the heads; inj bool[G, n] heads whose
    own weight is 0).  With rank_keys=True it returns merge_hot_cold_tam's
    two rank keys instead, int64[G, n] each: hkey = (s << 32) | count at an
    inj head, ckey = (-count << 32) | s at a head with count > 0 (not an
    inj head where skip_inj), _KEY_SENTINEL elsewhere.  Run sums must stay
    below 2^31 (weights are query positions, so a run sums to at most L).

    A CPU tensor takes rle_sorted_plain; a CUDA tensor takes the kernel
    (csrc/rle.cu) or raises."""
    if ks.dtype != torch.int64 or ks.dim() != 2:
        raise ValueError(f"ks: want int64 2-d, got {ks.dtype} {ks.dim()}-d")
    if not ks.is_contiguous():
        raise ValueError("ks must be contiguous")
    dev = ks.device
    if dev.type == "cpu":
        return rle_sorted_plain(ks, rank_keys, skip_inj)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    G, n = ks.shape
    if G * n >= 1 << 31:
        raise ValueError(f"ks has {G * n} entries; the kernel takes < 2^31")
    if ks.data_ptr() % 16:
        raise ValueError("ks must be 16-byte aligned")
    a = torch.empty_like(ks)
    if rank_keys:
        outs = (a, torch.empty_like(ks))
        ptrs = [a.data_ptr(), outs[1].data_ptr(), None, None]
    else:
        outs = (a, torch.empty((G, n), dtype=torch.int32, device=dev),
                torch.empty((G, n), dtype=torch.bool, device=dev),
                torch.empty((G, n), dtype=torch.bool, device=dev))
        ptrs = [t.data_ptr() for t in outs]
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        rc = lib.kt_rle_sorted(ks.data_ptr(), G * n, n, int(rank_keys),
                               int(skip_inj), *ptrs,
                               torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "rle_sorted")
    if torch.cuda.is_current_stream_capturing():
        _thread.recorded = thread_recorded() + 1
        return outs
    with _launch_lock:
        launches["rle_sorted"] += 1
    _thread.launches = thread_launches() + 1
    return outs


def sort_rle(rows: torch.Tensor, weights=None):
    """Sort each row multiset and run-length encode it (count.py:sort_rle).

    rows: int64[B, cap] (ROW_SENTINEL padding); weights: optional int64
    per-entry multiplicities (1 each without).  Returns (s int64[B, cap]
    sorted rows, counts int32[B, cap] with each run's weight sum at its
    start lane, is_start bool[B, cap]; sentinels excluded).

    One path replaces the JAX package's three branches (unweighted, the
    packed row << bits | w key and the two-operand sort): with int64 keys,
    (row << 32) | w always fits for rows < 2^31, and since RLE sums the
    weights of a run, the order among equal rows does not change any
    count."""
    if weights is None:
        weights = torch.ones_like(rows)
    s, counts, is_start, _ = rle_sorted(sort_weighted(rows, weights))
    return s, counts, is_start


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


def member_bitmap(postings: torch.Tensor, offs: torch.Tensor,
                  lens: torch.Tensor, hits: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """Position bitmaps by binary search on the device
    (count.py:member_bitmap; member_np is its host twin): bitmap[b, k, l]
    is True iff hit row hits[b, k] is in the sorted postings slice
    postings[offs[b, l] : offs[b, l] + lens[b, l]].

    postings int32[P] (uint32 rows); offs, lens int64[B, L]; hits
    int64[B, K] holding uint32 values; iters, a static bound
    ceil(log2(max_len + 1)) + 1 from the longest postings list.  Returns
    bool[B, K, L]: `iters` gathers of B * K * L elements, whatever the
    expansion cap."""
    B, K = hits.shape
    L = offs.shape[1]
    P = postings.shape[0]
    end = (offs + lens)[:, None, :].expand(B, K, L)
    lo = offs[:, None, :].expand(B, K, L)
    hi = end
    h = hits[:, :, None]
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = as_u32(postings[mid.clamp(0, P - 1)])
        go_right = active & (v < h)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    v = as_u32(postings[lo.clamp(0, P - 1)])
    return (lo < end) & (v == h)


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
