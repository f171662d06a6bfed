"""Multi-device search over a sharded k-mer index, in torch
(kaamer_tpu/parallel/mesh.py).

The host half is the JAX module's, copied unchanged: shard_index splits
an indexed artifact into per-shard cuckoo tables and postings by SET
identity (shard_owner), with the longest sets split contiguously across
all shards (split_set_mask); index/build.py's sharded build applies the
same rule, and the two layouts are equal array for array.

The device half is the JAX module's shard_map bodies as per-shard torch
steps over a (dp, shard) grid, joined by the collectives of comm.py.
Every per-device argument is a grid-shaped list, [dp row][shard], of
tensors on that cell's device (the dp rows of this process; the dp axis
continues across processes, comm.dp_all_gather):

- sharded_totals (make_sharded_totals): probe + run dedup + hot split on
  every shard; each query's max and sum over shards of its shard-local
  cold expansion volume, and its hot run weight.
- sharded_group (make_sharded_group): one phase-2 group.  Each shard
  expands its cold runs (ops/count.expand_hybrid with no tile tier: the
  entries of ops/count.gather_postings, which the JAX step calls), the
  rows and weights go through all_to_all so that shard i finalizes the
  i-th 1/n of the dp row's queries with every shard's postings, then
  weighted sort + RLE + top-k.  The hot step adds each shard's dense
  partial W @ M, summed exactly by psum_scatter (every posting lives on
  one shard), and the per-lane candidate-union merge
  (ops/hotset.merge_hot_cold), as the JAX engine does.  Positions: the
  merged top hits are gathered back to every shard, each shard builds
  its bitmaps from its own run structure, and the packed bitmaps
  OR-merge through one more all_to_all.
- sharded_search (make_sharded_search): the whole-batch step, with no
  hot split and no group schedule.  Each shard expands all its runs at
  `cap` (ops/count.gather_postings), the rows and weights go through
  all_to_all, then weighted sort + RLE + top-k; it also returns each
  query's largest shard-local expansion volume, and with positions the
  bitmaps of sharded_group's cold step.  replicate_query_batch pads a
  query batch for it; grid_index and grid_batch place the JAX step's
  host arrays on a Mesh.

The JAX module's pack_w_bits only chooses its sort-key layout; the port
sorts int64 keys everywhere (ops/count.sort_rle), which rank the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import codec
from ..index.artifact import DBArtifact
from ..index.hashtable import HASH_MULT, build_table, occupied_entries
from ..ops import hotset
from ..ops.count import (count_topk, dedup_runs, expand_hybrid,
                         expand_run_bitmaps, gather_postings,
                         member_bitmap_from_rows, pack_bits, sort_rle)
from ..ops.probe import probe_slices
from . import comm

KMER_SIZE = 7


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))


@dataclass
class ShardedIndexArrays:
    """Host-side per-shard index arrays, padded to uniform shapes.

    tables:      uint32[n_shards, rows, 6]  (hashtable.py cuckoo layout,
                 values = shard-LOCAL postings (start, len) inline)
    postings:    uint32[n_shards, P_max]
    set_offsets: per-shard LOCAL postings slice boundaries (unpadded),
                 uint64[S_s + 1] each -- drives shard-local hot-set
                 selection (ops/hotset.py) and diagnostics
    postings_sizes: true (unpadded) postings length per shard
    """

    tables: np.ndarray
    postings: np.ndarray
    hash_log2: int
    n_shards: int
    set_offsets: List[np.ndarray] = None
    postings_sizes: List[int] = None


def shard_owner(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard of a uint32 key: top bits of the multiplicative hash (the
    SAME hash family as slot placement uses lower-order of; ownership uses
    the highest bits so in-shard placement stays uniform).

    The index shards by SET identity (every k-mer of a postings set lands on
    the set's owner shard, shard_index_arrays below), NOT by k-mer: adjacent
    query positions that resolve to one set -- the run structure the
    query-time dedup collapses (ops/count.py:dedup_runs) -- then stay
    consecutive on the owner shard, so the per-query sharded expansion
    volume EQUALS the single-chip deduplicated volume.  K-mer-hash ownership
    would scatter a run's positions across shards (adjacent k-mers hash
    independently), fragmenting every run to ~length 1 and re-paying the
    multiplicity the dedup exists to remove."""
    h = keys.astype(np.uint32) * HASH_MULT
    return ((h.astype(np.uint64) * np.uint64(n_shards)) >> np.uint64(32)).astype(np.int64)


# Sets whose postings slice is at least n_shards * SPLIT_SUB_MIN long are
# SPLIT contiguously across all shards instead of owned by one: whole-set
# ownership concentrates the power-law head on single shards, capping cold
# expansion balance at tsum/(n*tmax) ~= 0.19 at 8 shards (SCALING_r03) --
# per-batch expansion time is then set by whichever shard owns the biggest
# hot domains.  A split set contributes len/n rows on EVERY shard: sums
# (and therefore counts after the concat-RLE merge) are unchanged, each
# shard's sub-slice is sorted (contiguous cut of a sorted slice) so host
# bitmaps/fallback still binary-search it, and adjacent query positions
# still dedup into one run per shard.  The floor keeps sub-slices worth a
# few gather rows (>= 8 postings each; measured on the SCALING_r04 workload
# at 8 shards: balance 0.396 / 0.507 / 0.640 / 0.757 for sub-min 32/16/8/4
# -- 8 clears the >= 0.5 bar with margin while splits stay row-worthy).
SPLIT_SUB_MIN = 8


def split_set_mask(set_lens: np.ndarray, n_shards: int) -> np.ndarray:
    """Which sets are split across all shards (vs owned by shard_owner)."""
    if n_shards <= 1:
        return np.zeros(set_lens.shape, dtype=bool)
    return set_lens.astype(np.int64) >= n_shards * SPLIT_SUB_MIN


def shard_index(art: DBArtifact, n_shards: int) -> ShardedIndexArrays:
    """Split an indexed artifact into per-shard probe structures."""
    return shard_index_arrays(
        np.asarray(art.hash_table),
        np.asarray(art.set_offsets),
        np.asarray(art.postings),
        n_shards,
    )


def shard_index_arrays(
    hash_table: np.ndarray,
    set_offsets: np.ndarray,
    postings: np.ndarray,
    n_shards: int,
) -> ShardedIndexArrays:
    kmers, g_starts, g_lens = occupied_entries(np.ascontiguousarray(hash_table))
    # dense global set ids, recovered from the inline starts (set starts are
    # strictly increasing; see hashtable.py)
    set_ids = np.searchsorted(set_offsets, g_starts.astype(np.uint64),
                              side="left").astype(np.uint32)

    global_starts = set_offsets.astype(np.int64)
    n_sets = global_starts.size - 1
    lens_all = global_starts[1:] - global_starts[:-1]

    # ownership by SET identity preserves the query-time run-dedup structure
    # (see shard_owner); dense set ids are uniform under Fibonacci hashing.
    # Long sets are SPLIT across all shards for load balance (split_set_mask)
    owner_of_set = shard_owner(np.arange(n_sets, dtype=np.uint32), n_shards)
    split = split_set_mask(lens_all, n_shards)

    shard_posts = []
    shard_keys = []
    shard_starts_v = []
    shard_lens_v = []
    shard_set_offsets = []
    for s in range(n_shards):
        sel_sets = split | (owner_of_set == s)
        local_sets = np.flatnonzero(sel_sets)  # ascending global ids
        ls_lens = lens_all[local_sets]
        ls_split = split[local_sets]
        # sub-slice [lo, hi) of each local set: shard s's contiguous cut of
        # a split set, the whole slice otherwise
        lo = global_starts[local_sets] + np.where(
            ls_split, ls_lens * s // n_shards, 0)
        hi = global_starts[local_sets] + np.where(
            ls_split, ls_lens * (s + 1) // n_shards, ls_lens)
        lens = hi - lo
        starts_local = np.zeros(local_sets.size + 1, dtype=np.int64)
        np.cumsum(lens, out=starts_local[1:])
        total = int(starts_local[-1])
        src = (
            np.repeat(lo, lens)
            + np.arange(total, dtype=np.int64)
            - np.repeat(starts_local[:-1], lens)
        )
        post_local = postings[src]

        ksel = sel_sets[set_ids]
        local_rank = np.searchsorted(local_sets, set_ids[ksel])
        shard_keys.append(kmers[ksel])
        shard_starts_v.append(starts_local[local_rank].astype(np.uint32))
        shard_lens_v.append(lens[local_rank].astype(np.uint32))
        shard_posts.append(post_local)
        shard_set_offsets.append(starts_local.astype(np.uint64))

    # build with a shared table size so all shard tables stack shape-
    # identically; grow the common log2 until every shard converges at it
    common_t = 0
    while True:
        shard_tables = [
            build_table(k, st, ln, min_log2=common_t)
            for k, st, ln in zip(shard_keys, shard_starts_v, shard_lens_v)
        ]
        t_max = max(t.log2 for t in shard_tables)
        if all(t.log2 == t_max for t in shard_tables):
            common_t = t_max
            break
        common_t = t_max

    P_max = max(1, _next_pow2(max(p.size for p in shard_posts)))
    tables = np.stack([t.table for t in shard_tables])
    posts_pad = np.zeros((n_shards, P_max), dtype=np.uint32)
    for s in range(n_shards):
        posts_pad[s, : shard_posts[s].size] = shard_posts[s]

    return ShardedIndexArrays(
        tables=tables,
        postings=posts_pad,
        hash_log2=common_t,
        n_shards=n_shards,
        set_offsets=shard_set_offsets,
        postings_sizes=[p.size for p in shard_posts],
    )


# ---------------------------------------------------------------------------
# Device-side sharded steps
# ---------------------------------------------------------------------------


def _probe_dedup(table, codes, n_kmers, hash_log2: int, miss_start: int,
                 width: int):
    """The front half of every sharded step (mesh.py:_probe_dedup):
    decode -> encode -> shard-local cuckoo probe -> query-time run dedup.
    codes: wire words (width > 0) -- int32[B, ceil(width/7)] holding the
    uint32 words of pack_codes7, or in any other integer dtype the uint16
    words of pack_codes3, as the JAX module tells uint32 from uint16 --
    or residue codes (width 0); n_kmers: int64[B].  Returns (offs, lens,
    lens_u, wstart, run_start) int64[B, L] and L."""
    if not width:
        codes = codes.to(torch.int64)
    elif codes.dtype == torch.int32:
        codes = codec.unpack_codes7(codes, width)
    else:
        codes = codec.unpack_codes3(codes, width)
    L = codes.shape[1] - (KMER_SIZE - 1)
    kmers = codec.encode_kmers(codes, L)
    starts, lens = probe_slices(table, kmers, hash_log2, miss_start)
    lane = torch.arange(L, device=codes.device)[None, :]
    in_query = lane < n_kmers[:, None]
    offs = torch.where(in_query, starts, miss_start)
    lens = torch.where(in_query, lens, 0)
    lens_u, wstart, run_start = dedup_runs(offs, lens)
    return offs, lens, lens_u, wstart, run_start, L


def _rows_on(blocks, device) -> torch.Tensor:
    """Row blocks concatenated in order on one device."""
    return torch.cat([b.to(device, non_blocking=True) for b in blocks])


def sharded_totals(tables, thresh, codes, n_kmers, *, hash_log2: int,
                   miss_start: int, width: int = 0):
    """make_sharded_totals: probe + run dedup + hot split on every shard.

    tables, codes, n_kmers: [dp][shard] (each dp row's block of the batch
    on every device of the row); thresh: each shard's hot-set length
    threshold (2^30: none).  Returns (tmax, tsum, hot_sum) int64[B] over
    the whole batch, every process's dp rows in order: each query's max
    over shards of its shard-local cold expansion volume (the group cap),
    their sum (the single-device deduplicated volume) and its hot run
    weight.  Every shard holds the same values; these are the first
    shard's, on the device of tables[0][0]."""
    rows = []
    for tab_r, codes_r, n_r in zip(tables, codes, n_kmers):
        cold, whot = [], []
        for s, (tab, c, nk) in enumerate(zip(tab_r, codes_r, n_r)):
            _, lens, lens_u, wstart, _, _ = _probe_dedup(
                tab, c, nk, hash_log2, miss_start, width)
            hot = lens >= thresh[s]
            whot.append(torch.where(hot & (lens_u > 0), wstart, 0).sum(1))
            cold.append(torch.where(hot, 0, lens_u).sum(1))
        rows.append((comm.pmax(cold)[0], comm.psum(cold)[0],
                     comm.psum(whot)[0]))
    dev = tables[0][0].device
    return tuple(comm.dp_all_gather(_rows_on([r[j] for r in rows], dev))
                 for j in range(3))


def _or_merge_bitmaps(packed, counts):
    """OR-merge per-shard packed bitmaps [B, K, L8] through one all_to_all
    (mesh.py:_or_merge_bitmaps): each shard receives every shard's
    contributions for its B/n queries and bit-ors them; padding hits
    (count 0) are zeroed."""
    n = len(packed)
    out = []
    for m, c in zip(comm.all_to_all(packed, 0, 1), counts):
        m = m.reshape(m.shape[0], n, m.shape[1] // n, m.shape[2])
        bits = m[:, 0]
        for j in range(1, n):
            bits = bits | m[:, j]
        out.append(torch.where(c[:, :, None] > 0, bits, 0))
    return out


def _position_round(rows, seg, run_starts, hits, counts, L: int,
                    extra=None):
    """The positions round of the sharded steps (mesh.py:position_round):
    the merged top hits are gathered back to every shard, each shard
    builds its bitmaps from its own expansion and run structure (plus
    extra(s, hits) where given), and the packed bitmaps OR-merge."""
    hits_all = comm.all_gather(hits, 0)
    packed = []
    for s in range(len(rows)):
        found = expand_run_bitmaps(
            member_bitmap_from_rows(rows[s], seg[s], hits_all[s], L),
            run_starts[s])
        if extra is not None:
            found = found | extra(s, hits_all[s])
        packed.append(pack_bits(found))
    return _or_merge_bitmaps(packed, counts)


def _group_row(tables, postings, codes, n_kmers, hot, hash_log2: int,
               cap: int, k: int, width: int, positions: bool):
    """make_sharded_group's local_step over one dp row's shards.  Returns
    per-shard lists (counts, hit_rows[, bits]) of each shard's B/n
    finalized queries."""
    n = len(tables)
    fronts, rows, seg, w = [], [], [], []
    for s in range(n):
        offs, lens, lens_u, wstart, run_start, L = _probe_dedup(
            tables[s], codes[s], n_kmers[s], hash_log2,
            postings[s].shape[0], width)
        whot = None
        if hot is not None:
            hot_mask = lens >= hot[0][s]
            whot = torch.where(hot_mask & (lens_u > 0), wstart, 0)
            lens_u = torch.where(hot_mask, 0, lens_u)
        r, sg, _, wt = expand_hybrid(postings[s], offs,
                                     torch.cumsum(lens_u, dim=1), wstart,
                                     None, None, cap, 0)
        fronts.append((offs, run_start, whot))
        rows.append(r)
        seg.append(sg)
        w.append(wt)
    rows_ex = comm.all_to_all(rows, 0, 1)
    w_ex = comm.all_to_all(w, 0, 1)
    if hot is None:
        res = [count_topk(r, k, weights=wt) for r, wt in zip(rows_ex, w_ex)]
    else:
        _, M, _, hstarts = hot
        partial = [hotset.hot_matmul(
            hotset.hot_weights(offs, whot, hstarts[s]), M[s], max_w=L)
            for s, (offs, _, whot) in enumerate(fronts)]
        # every posting lives on exactly one shard, so summing the
        # shards' dense partials merges exactly; the scatter leaves each
        # shard its own B/n query rows
        counts_hot = comm.psum_scatter(partial, 0)
        res = [hotset.merge_hot_cold(ch, *sort_rle(r, weights=wt), k)
               for ch, r, wt in zip(counts_hot, rows_ex, w_ex)]
    counts = [c for c, _ in res]
    hits = [h for _, h in res]
    if not positions:
        return counts, hits

    def hot_bits(s, hits_s):
        offs, run_start, whot = fronts[s]
        return hotset.hot_position_bitmaps(
            offs, hotset.hot_lane_mask(whot, run_start), hot[3][s],
            hot[2][s], hits_s)

    return counts, hits, _position_round(
        rows, seg, [f[1] for f in fronts], hits, counts, L,
        None if hot is None else hot_bits)


def sharded_group(tables, postings, codes, n_kmers, *, hash_log2: int,
                  cap: int, k: int, width: int = 0, positions: bool = False,
                  hot=None, replicate_out: bool = False):
    """make_sharded_group: one phase-2 group of the sharded engine at
    expansion capacity `cap` per shard.

    tables, postings, codes, n_kmers: [dp][shard] (postings int32[P_max]
    holding uint32 rows; a dp row's block of the group on every device of
    the row).  hot: None for the cold step, or (thresh, M, MT, hot_starts)
    for the dense hot-set step: each shard's length threshold, and
    [dp][shard] membership M[H, P_pad] (float32 or bfloat16), its
    transpose MT bf16[P_pad, H] and the ascending hot slice starts
    int64[H] (unused entries hold a value above every slice start).

    Returns (counts int32[G', k], hit_rows int64[G', k][, bitmaps
    uint8[G', k, L // 8] with positions]) in the P(("dp", "shard")) row
    order (dp-major, shard-minor) on the device of tables[0][0]: G' is
    this process's rows, or with replicate_out every process's (the JAX
    engine's multi-controller serving, where each process schedules the
    whole batch)."""
    per_row = [_group_row(t, p, c, nk, None if hot is None else
                          (hot[0], hot[1][i], hot[2][i], hot[3][i]),
                          hash_log2, cap, k, width, positions)
               for i, (t, p, c, nk) in enumerate(zip(tables, postings, codes,
                                                     n_kmers))]
    dev = tables[0][0].device
    outs = tuple(_rows_on([b for row in per_row for b in row[j]], dev)
                 for j in range(len(per_row[0])))
    if replicate_out:
        outs = tuple(comm.dp_all_gather(o) for o in outs)
    return outs


def _search_row(tables, postings, codes, n_kmers, hash_log2: int, cap: int,
                k: int, width: int, positions: bool):
    """make_sharded_search's local_step over one dp row's shards.  Returns
    per-shard lists (counts, hit_rows, totals[, bits]) of each shard's B/n
    finalized queries."""
    rows, seg, w, totals, run_starts = [], [], [], [], []
    for s in range(len(tables)):
        offs, _, lens_u, wstart, run_start, L = _probe_dedup(
            tables[s], codes[s], n_kmers[s], hash_log2,
            postings[s].shape[0], width)
        cum = torch.cumsum(lens_u, dim=1)
        r, sg, _, wt = gather_postings(postings[s], offs, cum, cum[:, -1],
                                       cap, wstart=wstart)
        rows.append(r)
        seg.append(sg)
        w.append(wt)
        totals.append(cum[:, -1])
        run_starts.append(run_start)
    res = [count_topk(r, k, weights=wt)
           for r, wt in zip(comm.all_to_all(rows, 0, 1),
                            comm.all_to_all(w, 0, 1))]
    counts = [c for c, _ in res]
    hits = [h for _, h in res]
    # every shard holds the max; each keeps its own B/n queries' part
    tmax = [t[:, 0] for t in comm.all_to_all(
        [t[:, None] for t in comm.pmax(totals)], 0, 1)]
    if not positions:
        return counts, hits, tmax
    return counts, hits, tmax, _position_round(rows, seg, run_starts, hits,
                                               counts, L)


def sharded_search(tables, postings, codes, n_kmers, *, hash_log2: int,
                   cap: int, k: int, width: int = 0,
                   positions: bool = False):
    """make_sharded_search: the whole-batch sharded search step (the
    serving engine runs sharded_totals and sharded_group instead).  Every
    shard probes and run-deduplicates the batch and expands all its runs
    at capacity `cap` (entries past it are dropped, as in the JAX step);
    the merged rows are counted and ranked on the shard that finalizes
    them.

    tables, postings, codes, n_kmers: [dp][shard], as sharded_group takes
    them (grid_index and grid_batch place the JAX step's host arrays so).
    Returns (counts int32[G', k], hit_rows int64[G', k], totals
    int64[G'][, bitmaps uint8[G', k, L // 8] with positions]) in the
    P(("dp", "shard")) row order on the device of tables[0][0], G' being
    this process's rows; totals is each query's largest shard-local
    deduplicated postings volume, so a cap at or above totals.max()
    loses nothing."""
    per_row = [_search_row(t, p, c, nk, hash_log2, cap, k, width, positions)
               for t, p, c, nk in zip(tables, postings, codes, n_kmers)]
    dev = tables[0][0].device
    return tuple(_rows_on([b for row in per_row for b in row[j]], dev)
                 for j in range(len(per_row[0])))


def _signed(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor, uint32 and uint16 words viewed as int32
    and int16 (_probe_dedup tells the wire formats apart by them)."""
    a = np.ascontiguousarray(a)
    view = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
    return torch.from_numpy(a.view(view.get(a.dtype, a.dtype)))


def grid_index(sharded: ShardedIndexArrays, mesh):
    """sharded_search's (tables, postings) on a parallel.dist.Mesh, as
    [dp][shard] lists: each shard's table and postings (uint32 held as
    int32) on every device of its column, one copy a device."""
    cols = []
    for s in range(sharded.n_shards):
        host = (_signed(sharded.tables[s]), _signed(sharded.postings[s]))
        cols.append({d: tuple(h.to(d) for h in host)
                     for d in dict.fromkeys(r[s] for r in mesh.devices)})
    return tuple([[cols[s][d][j] for s, d in enumerate(row)]
                  for row in mesh.devices] for j in range(2))


def grid_batch(codes, n_kmers, mesh):
    """sharded_search's (codes, n_kmers) on a parallel.dist.Mesh, as
    [dp][shard] lists, from the global batch the JAX step takes (residue
    codes or wire words, and k-mer counts): the block of each of this
    process's dp rows on every device of the row."""
    per = codes.shape[0] // mesh.shape["dp"]
    base = mesh.rank * len(mesh.devices)
    rows_c, rows_n = [], []
    for i, row in enumerate(mesh.devices):
        lo = (base + i) * per
        c = _signed(codes[lo:lo + per])
        n = torch.from_numpy(np.asarray(n_kmers[lo:lo + per], np.int64))
        on = {d: (c.to(d), n.to(d)) for d in dict.fromkeys(row)}
        rows_c.append([on[d][0] for d in row])
        rows_n.append([on[d][1] for d in row])
    return rows_c, rows_n


def replicate_query_batch(seqs, sizes, batch_mult: int):
    """Pad a query batch so B is divisible by dp*shard, returning codes and
    n_kmers arrays (padding queries have 0 k-mers)."""
    B0 = len(seqs)
    B = max(batch_mult, ((B0 + batch_mult - 1) // batch_mult) * batch_mult)
    L = _next_pow2(max(max(sizes), 8) if sizes else 8)
    codes = np.full((B, L + KMER_SIZE - 1), -1, dtype=np.int32)
    n_kmers = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = codec.seq_to_codes(s)[: L + KMER_SIZE - 1]
        codes[i, : c.shape[0]] = c
        n_kmers[i] = sizes[i]
    return codes, n_kmers
