"""Batched search engine on torch tensors (kaamer_tpu/search/engine.py),
cold path.

The pipeline is the JAX engine's, on one explicit device:

  host: pack queries to the base-22 wire format (native packer)
  dev : phase 1 -- unpack, encode 7-mers, cuckoo probe, run dedup, tier
        split, exact per-query expansion totals
  host: group queries by totals into phase-2 chunks (the JAX engine's
        planner, reused as is)
  dev : phase 2 per chunk -- two-tier postings expansion, sort, RLE, top-k
  host: QueryCounts per query (the JAX engine's _finalize_pending)

Hot sets (the dense matmul path for the longest postings sets) are not
ported yet: every run expands on the cold path, which gives the same
counts.  Position bitmaps come from the host binary search, the path the
JAX engine takes whenever its device bitmaps do not fit
(_positions_on_device).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from kaamer_tpu import codec as host_codec
from kaamer_tpu import native
from kaamer_tpu.index.artifact import DBArtifact
from kaamer_tpu.search.engine import (
    CAP_MAX, CAP_MIN, DISPATCH_COST_ROWS, G_QUANTA, KMER_SIZE,
    MAX_EXPANSION_ELEMS, TOPK_MIN, T_SPLIT, PositionBitmapServing,
    QueryCounts, _cap_bucket, _cap_bucket_vec, _cap_floor, _finalize_pending,
    _next_pow2, _plan_normal_chunks)

from .. import codec
from ..ops.count import count_topk, dedup_runs, expand_hybrid, member_np
from ..ops.probe import probe_slices


def engine_state_from_artifact(art: DBArtifact, device) -> Dict[str, torch.Tensor]:
    """The device-resident index of an artifact: the cuckoo table
    (int32[rows, 6] holding uint32) and the postings (int32[P_pad] holding
    uint32, zero-padded to a whole number of 128-wide tiles, as the JAX
    engine pads them for its tile tier).  Both engines read the same
    numpy arrays of one artifact."""
    postings = np.asarray(art.postings, dtype=np.uint32)
    pad = (-len(postings)) % 128
    postings = np.concatenate([postings, np.zeros(pad, np.uint32)])
    table = np.array(art.hash_table, dtype=np.uint32)
    return {
        "table": torch.from_numpy(table.view(np.int32)).to(device),
        "postings": torch.from_numpy(postings.view(np.int32)).to(device),
    }


def _phase1_impl(table, codes, n_kmers, *, hash_log2: int, miss_start: int,
                 hot_thresh: int = 1 << 30, width: int = 0):
    """engine.py:_phase1_impl in torch.

    codes: int32[B, ceil(width/7)] wire words from pack_codes7 (width > 0)
    or int64[B, L+6] residue codes; n_kmers: int64[B].  Returns the JAX
    function's ten outputs (offs, cum_s, wstart, run_start, whot, cum_t,
    lens_l, totals_s, totals_t, hot_sums) as int64 tensors."""
    if width:
        codes = codec.unpack_codes7(codes, width)
    L = codes.shape[1] - (KMER_SIZE - 1)
    kmers = codec.encode_kmers(codes, L)
    starts, lens = probe_slices(table, kmers, hash_log2, miss_start)
    lane = torch.arange(L, device=codes.device)[None, :]
    in_query = lane < n_kmers[:, None]
    offs = torch.where(in_query, starts, miss_start)
    lens = torch.where(in_query, lens, 0)
    lens_u, wstart, run_start = dedup_runs(offs, lens)
    hot = lens >= hot_thresh
    whot = torch.where(hot & (lens_u > 0), wstart, 0)
    long = ~hot & (lens_u >= T_SPLIT)
    cum_s = torch.cumsum(torch.where(hot | long, 0, lens_u), dim=1)
    rows_l = torch.where(long, ((offs & 127) + lens_u + 127) >> 7, 0)
    cum_t = torch.cumsum(rows_l, dim=1)
    lens_l = torch.where(long, lens_u, 0)
    return (offs, cum_s, wstart, run_start, whot, cum_t, lens_l,
            cum_s[:, -1], cum_t[:, -1], whot.sum(dim=1))


def _phase2_grouped_impl(postings, offs, cum_s, wstart, cum_t, lens_l, *,
                         cap_s: int, cap_t: int, k: int):
    """engine.py:_phase2_grouped_impl (positions=False) in torch: two-tier
    expansion + weighted count + rank.  Returns (counts int32[G, k],
    hit_rows int64[G, k]).  The JAX function's run_start argument fed only
    its device bitmaps and is dropped."""
    rows, _, _, w = expand_hybrid(postings, offs, cum_s, wstart, cum_t,
                                  lens_l, cap_s, cap_t)
    return count_topk(rows, k, weights=w)


class _HostFetch:
    """The device_get that _finalize_pending calls: one pass moving every
    chunk's (counts, hit_rows) to the host, as int32 counts and uint32
    rows (the JAX engine's host dtypes)."""

    @staticmethod
    def device_get(tree):
        return [[t.cpu().numpy().astype(np.uint32 if t.dtype == torch.int64
                                         else np.int32, copy=False)
                 for t in outs] for outs in tree]


class _BatchIds:
    """A batch's per-k-mer slice starts, left on the device and pulled to
    the host at most once, when a query needs position bitmaps or the
    host count."""

    def __init__(self, offs: torch.Tensor):
        self._dev = offs
        self._np = None

    def host(self) -> np.ndarray:
        if self._np is None:
            self._np = self._dev.cpu().numpy()
            self._dev = None
        return self._np


class SearchEngine(PositionBitmapServing):
    """Holds the device-resident index on one device and runs batched
    searches (the JAX SearchEngine's cold path)."""

    # sub-batch and group widths of the JAX engine's planner
    RERUN_B = 16
    GROUP_B = 256

    def __init__(self, art: DBArtifact, device, hot: bool = False):
        if hot:
            raise NotImplementedError(
                "hot sets are not ported yet (ROADMAP Queue 1 item 4, "
                "ops/hotset.py); construct with hot=False")
        if not art.indexed:
            raise ValueError("database is not indexed; run index_db first")
        if getattr(art, "index_shards", 0):
            raise ValueError(
                f"this database was built with {art.index_shards} index "
                f"shards; sharded serving is not ported yet")
        so = np.asarray(art.set_offsets)
        if so.size and int(so[-1]) >= 2**31:
            raise ValueError("postings larger than 2^31 need a sharded index")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        self.art = art
        state = engine_state_from_artifact(art, self.device)
        self.table = state["table"]
        self.postings = state["postings"]
        # +sentinel "empty set" row: a miss reports start == P, which
        # searchsorted maps to the sentinel set n_sets
        self.set_starts_np = np.concatenate([so, so[-1:]]).astype(np.int32)
        self.postings_np = np.asarray(art.postings)
        self.n_sets = int(so.size - 1)
        self.miss_start = int(so[-1]) if so.size else 0
        self.hash_log2 = art.hash_log2

    def count_batch(self, seqs: Sequence[str], sizes: Sequence[int], k: int,
                    positions: bool = False) -> List[QueryCounts]:
        """Count k-mer hits for a batch of queries (kmers [0, size) of each
        query are searched)."""
        return self.resolve_batch(self.dispatch_batch(seqs, sizes, k,
                                                      positions=positions))

    def dispatch_batch(self, seqs: Sequence[str], sizes: Sequence[int], k: int,
                       positions: bool = False):
        """Upload one batch and enqueue phase 1; returns a handle for
        schedule_batch.  positions is accepted for the pipeline's call:
        bitmaps always come from the host path."""
        if len(seqs) == 0:
            return None
        L = _next_pow2(max(max(sizes), 8))
        width = L + KMER_SIZE - 1
        wire = native.pack_queries(seqs, width)
        if wire is None:
            wire = host_codec.pack_codes7(
                host_codec.pad_codes_batch(seqs, width))
        codes = torch.from_numpy(wire.view(np.int32)).to(self.device)
        n_kmers = torch.tensor(list(sizes), dtype=torch.int64,
                               device=self.device)
        outs1 = _phase1_impl(self.table, codes, n_kmers,
                             hash_log2=self.hash_log2,
                             miss_start=self.miss_start, width=width)
        return (outs1, list(sizes), k)

    def resolve_batch(self, handle, min_top: int = 0) -> List[QueryCounts]:
        return self.collect_batch(self.schedule_batch(handle), min_top)

    def _quantized_groups(self, cap: int, B: int) -> List[int]:
        """Phase-2 group widths for this cap: G_QUANTA within the
        expansion budget."""
        g_budget = max(16, 1 << (MAX_EXPANSION_ELEMS // cap).bit_length() - 1)
        return [g for g in G_QUANTA if g <= min(g_budget, B) or g == 16]

    def schedule_batch(self, handle):
        """Group the batch's queries by their exact phase-1 totals and
        enqueue every phase-2 chunk (the JAX engine's schedule_batch without
        hot chunks or warmup cap pinning): outliers above the group budget
        run in narrow chunks at the pow2 cap they need, beyond CAP_MAX a
        query is counted on the host."""
        if handle is None:
            return None
        outs1, sizes, k = handle
        ts_h = outs1[7].cpu().numpy()
        tt_h = outs1[8].cpu().numpy()
        # effective expansion volume: tile rows pay 128 sort lanes each
        totals_h = ts_h + 128 * tt_h
        B = len(sizes)
        batch_ids = _BatchIds(outs1[0])
        k_full = _next_pow2(max(k, TOPK_MIN))
        results: Dict[int, QueryCounts] = {}

        limit_g = _cap_floor(MAX_EXPANSION_ELEMS // min(self.GROUP_B, B))
        order = np.argsort(-totals_h, kind="stable").tolist()
        totals_l = totals_h.tolist()
        ts_l = ts_h.tolist()
        tt_l = tt_h.tolist()
        caps_l = np.minimum(_cap_bucket_vec(totals_h), limit_g).tolist()
        normal: List[int] = []
        heavy: List[int] = []
        chunks: List[tuple] = []  # (rows, G, rerun)
        for i in order:
            t = totals_l[i]
            if t > CAP_MAX:
                results[i] = self._count_host_row(batch_ids, i, sizes[i],
                                                  k_full)
            elif t > limit_g:
                heavy.append(i)
            else:
                normal.append(i)

        c0 = 0
        while c0 < len(heavy):
            rem = len(heavy) - c0
            cap_c = _next_pow2(max(totals_l[heavy[c0]], CAP_MIN))
            G_c, best = self.RERUN_B, None
            for g in (4, self.RERUN_B):
                take = min(g, rem)
                waste = g * cap_c - sum(
                    totals_l[i] for i in heavy[c0 : c0 + take])
                score = (DISPATCH_COST_ROWS + waste) / take
                if best is None or score < best:
                    G_c, best = g, score
            chunks.append((heavy[c0 : c0 + G_c], G_c, True))
            c0 += G_c

        planned = _plan_normal_chunks(
            normal, totals_l, [False] * B, caps_l, 0,
            lambda cap_c, hot0: self._quantized_groups(cap_c, B),
            lambda: 0)
        chunks.extend((rows, G_c, False) for rows, G_c, _, _ in planned)

        def tier_caps(rows, rerun):
            max_s = max(ts_l[i] for i in rows)
            max_t = max(tt_l[i] for i in rows)
            cs = (min(_next_pow2(max(max_s, CAP_MIN)), CAP_MAX) if rerun
                  else _cap_bucket(max_s))
            ct = max(32, _next_pow2(max_t)) if max_t else 0
            return cs, ct

        pending = []
        for rows, G_c, rerun in chunks:
            cap_s, cap_t = tier_caps(rows, rerun)
            cap_e = cap_s + 128 * cap_t
            # per-tier buckets can overshoot the planner's budget: re-split
            # at the width the true cap affords (engine.py:793-808)
            if G_c > 16 and G_c * cap_e > 2 * MAX_EXPANSION_ELEMS:
                g_ok = max(g for g in G_QUANTA
                           if g <= max(2 * MAX_EXPANSION_ELEMS // cap_e, 16))
                for s0 in range(0, len(rows), g_ok):
                    sub = rows[s0 : s0 + g_ok]
                    cs, ct = tier_caps(sub, rerun)
                    pending.append((sub, self._dispatch_group(
                        outs1, sub, cs, ct, k_full)))
                continue
            pending.append((rows, self._dispatch_group(
                outs1, rows, cap_s, cap_t, k_full)))
        return [pending, results, sizes, B, batch_ids]

    def collect_batch(self, sched, min_top: int = 0) -> List[QueryCounts]:
        """Fetch every phase-2 chunk's outputs and build per-query
        QueryCounts; min_top > 0 turns rows whose top count is below it
        into None."""
        if sched is None:
            return []
        pending, results, sizes, B, batch_ids = sched
        return _finalize_pending(_HostFetch, pending, results, sizes, B,
                                 batch_ids, self, min_top)

    def _dispatch_group(self, outs1, rows: List[int], cap_s: int, cap_t: int,
                        k_full: int):
        """Enqueue one phase-2 chunk over the given batch rows; returns the
        (outputs, pos_dev, flagged) item _finalize_pending reads."""
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)
        offs, cum_s, wstart, _, _, cum_t, lens_l = (
            t.index_select(0, idx) for t in outs1[:7])
        k2 = min(k_full, cap_s + 128 * cap_t)
        outs2 = _phase2_grouped_impl(self.postings, offs, cum_s, wstart,
                                     cum_t, lens_l, cap_s=cap_s, cap_t=cap_t,
                                     k=k2)
        return outs2, False, False

    def _host_bitmaps_np(self, qc: QueryCounts, hit_rows) -> Dict[int, np.ndarray]:
        hits = np.asarray(list(hit_rows), dtype=np.uint32)
        if hits.size == 0 or qc.offs.size == 0:
            return {}
        found = member_np(self.postings_np, qc.offs, qc.lens, hits)
        return {int(h): found[j] for j, h in enumerate(hits)}

    def _count_host_row(self, batch_ids: _BatchIds, i: int, n_kmers: int,
                        k: int) -> QueryCounts:
        """Unbounded host count (np.bincount) for a query whose expansion
        exceeds CAP_MAX (engine.py:979-1004)."""
        offs = batch_ids.host()[i, :n_kmers].astype(np.int64)
        starts = self.set_starts_np
        ids = np.searchsorted(starts, offs, side="left")
        lens = (starts[ids + 1] - starts[ids]).astype(np.int64)
        segs = [self.postings_np[int(o) : int(o) + int(l)]
                for o, l in zip(offs, lens) if l > 0]
        if segs:
            bc = np.bincount(np.concatenate(segs))
            nz = np.flatnonzero(bc)
            order = np.lexsort((nz, -bc[nz]))[:k]
            hit_rows = nz[order].astype(np.uint32)
            counts = bc[hit_rows].astype(np.int32)
        else:
            hit_rows = np.empty(0, np.uint32)
            counts = np.empty(0, np.int32)
        qc = QueryCounts(hit_rows=hit_rows, counts=counts, _engine=self,
                         _n_kmers=n_kmers)
        qc._offs = offs
        qc._lens = lens
        return qc
