"""Distributed runtime glue and the grouped sharded search engine, in torch
(kaamer_tpu/parallel/dist.py).

The JAX engine is one controller per host driving a (dp, shard) mesh of
that host's devices; processes join only along dp (jax.distributed).  The
port keeps that structure:

- a Mesh is a single-process (dp, shard) grid of torch devices.  A device
  may repeat in it (the counterpart of JAX's virtual CPU devices), so on
  one card two shards can share cuda:0 and the sharded code really runs;
- the collectives are plain torch over the per-shard tensors of one dp
  row (comm.py);
- torch.distributed enters only where JAX crosses processes: the dp
  gathers of the phase-1 totals and of replicated group outputs
  (comm.dp_all_gather).  init_distributed joins the process group from
  the same KAAMER_* environment contract, gloo for the CPU and NCCL for
  CUDA.

The engine mirrors the single-device two-phase design (search/engine.py):
phase 1 (mesh.sharded_totals) probes + run-dedups + hot-splits on every
shard and reports each query's exact MAX shard-local cold total; the host
schedules phase 2 in totals-sorted coalesced GROUPS, each re-uploaded
(wire rows are host numpy, so a group may mix rows across dp blocks) and
run by mesh.sharded_group at the cap bucket it needs.  Hot queries take
the dense path with PER-SHARD membership matrices, merged exactly by
psum_scatter and the per-lane legacy merge.  Groups re-probe their k-mers,
so one postings-heavy query never drags a whole batch to its expansion
capacity; postings-heavy outliers fall back to the exact host bincount.
Uploads are pinned and non-blocking (upload.py), so dispatch waits for no
device; the host reads the card at the totals (schedule_batch) and the
group outputs (collect_batch), as the single-device engine does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as torch_dist

from .. import codec, native
from ..ops import hotset
from ..search import engine as search_engine
from ..search.engine import (G_QUANTA, HOT_DENSE_BYTES, MAX_EXPANSION_ELEMS,
                             TOPK_MIN, PositionBitmapServing, QueryCounts,
                             _cap_bucket_vec, _cap_floor,
                             _finalize_pending, _next_pow2,
                             _plan_normal_chunks, _tally, _warm_batches,
                             _warm_step, _warming)
from ..upload import upload_each
from . import comm
from .mesh import (ShardedIndexArrays, shard_index, sharded_group,
                   sharded_totals)

KMER_SIZE = 7
# hot_starts padding of shards with fewer hot sets than the widest: above
# every slice start (< 2^32), so no lane ever matches it (the JAX engine
# pads with -1, which its one-hot compare never matches either)
NO_START = 1 << 40


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group with env-var fallbacks
    (KAAMER_COORDINATOR host:port, KAAMER_NUM_PROCESSES,
    KAAMER_PROCESS_ID); a no-op without a coordinator (a single-process
    run).  Collectives on CPU tensors run on gloo, on CUDA tensors on
    NCCL (where torch has CUDA)."""
    coordinator_address = (coordinator_address
                           or os.environ.get("KAAMER_COORDINATOR"))
    if num_processes is None and "KAAMER_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KAAMER_NUM_PROCESSES"])
    if process_id is None and "KAAMER_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KAAMER_PROCESS_ID"])
    if coordinator_address is None:
        return
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    torch_dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


class Mesh:
    """A (dp, shard) grid of this process's torch devices, devices[i][s].
    With a process group initialised, the dp axis continues across
    processes: rank r holds global dp rows r * dp_local ... (the JAX
    engine's multi-controller layout), so shape["dp"] counts every
    process's rows.  A CUDA device that is not present raises."""

    def __init__(self, devices):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError(f"a mesh is a non-empty rectangular grid, "
                             f"not {devices!r}")
        for row in grid:
            for j, d in enumerate(row):
                if d.type != "cuda":
                    continue
                if not torch.cuda.is_available():
                    raise RuntimeError(f"mesh device {d}: CUDA is not "
                                       "available")
                if d.index is None:
                    row[j] = d = torch.device("cuda",
                                              torch.cuda.current_device())
                if d.index >= torch.cuda.device_count():
                    raise RuntimeError(f"mesh device {d}: only "
                                       f"{torch.cuda.device_count()} CUDA "
                                       "devices")
        self.devices = grid
        self.world, self.rank = comm.world()
        self.shape = {"dp": len(grid) * self.world, "shard": len(grid[0])}

    def distinct(self) -> List[torch.device]:
        """The grid's devices, each once, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def global_mesh(n_shards: Optional[int] = None, devices=None) -> Mesh:
    """(dp, shard) Mesh over the list `devices` (default: every CUDA
    card), in which a device may repeat.  The shard axis defaults to the
    device count and shrinks to a divisor of it; dp takes the rest."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices (a list or a "
                               "[dp][shard] grid) to build a mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if n_shards is None:
        n_shards = n
    while n % n_shards:
        n_shards -= 1
    return Mesh([devices[i:i + n_shards] for i in range(0, n, n_shards)])


class ShardedSearchEngine(PositionBitmapServing):
    """Counting engine over a sharded index on a (dp, shard) Mesh.  It has
    the single-device engine's dispatch/schedule/collect contract, so the
    search pipelines and their batch pipelining run unchanged on top of
    it, with bit-identical results."""

    CAP_MIN = 1 << 6   # per shard; the merge concatenates n_shards * cap
    CAP_MAX = 1 << 18  # per shard
    RERUN_B = 16
    GROUP_B = 256
    # the JAX sharded engine's cap ladder (parallel/dist.py:107)
    WARM_CAPS = (CAP_MIN, 96, 128, 192, 256, 320, 384, 512)

    def __init__(self, art, mesh=None, hot: bool = True):
        """mesh: a Mesh, a [dp][shard] grid of devices, or None for
        global_mesh() over every card."""
        if mesh is None:
            mesh = global_mesh()
        self.mesh = mesh if isinstance(mesh, Mesh) else Mesh(mesh)
        self.art = art
        self.n_shards = self.mesh.shape["shard"]
        self.dp = self.mesh.shape["dp"]
        self.mult = self.dp * self.n_shards
        # the device outputs are gathered on, and -aln's device
        self.device = self.mesh.devices[0][0]
        # dispatched phase-2 groups by kind
        self.stats = {"cold": 0, "hot": 0}

        if getattr(art, "index_shards", 0):
            # build-time per-shard artifacts (index_db n_shards > 1): the
            # shard arrays load directly -- no global artifact exists (the
            # only layout past build.MAX_POSTINGS), so the host fallbacks
            # run over a virtual concatenation of the shard postings
            if art.index_shards != self.n_shards:
                raise ValueError(
                    f"artifact has {art.index_shards} index shards; the "
                    f"mesh 'shard' axis is {self.n_shards} -- they must "
                    f"match (re-index or use an {art.index_shards}-shard "
                    f"mesh)")
            tables_l = [np.asarray(t) for t in art.shard_tables]
            posts_l = [np.asarray(p) for p in art.shard_postings]
            sizes = [int(p.shape[0]) for p in posts_l]
            self.sharded = ShardedIndexArrays(
                tables=None, postings=None,  # device-resident only
                hash_log2=art.hash_log2, n_shards=self.n_shards,
                set_offsets=[np.asarray(o) for o in art.shard_set_offsets],
                postings_sizes=sizes)
            self.postings_np = _ConcatPostings(posts_l)
            self._post_bases = self.postings_np.bases
            P_max = max(1, _next_pow2(max(sizes)))
            # set_starts_np is built lazily by __getattr__ (only the host
            # fallbacks need it, and it is O(total sets) in memory)
        else:
            self.sharded = shard_index(art, self.n_shards)
            tables_l = list(self.sharded.tables)
            posts_l = [self.sharded.postings[s, :sz] for s, sz in
                       enumerate(self.sharded.postings_sizes)]
            so = np.asarray(art.set_offsets)
            # int64 starts, searched with int64 keys (no cast per query)
            self.set_starts_np = np.concatenate([so, so[-1:]]).astype(
                np.int64)
            self.postings_np = np.asarray(art.postings)
            P_max = int(self.sharded.postings.shape[1])

        self._posts_local = posts_l  # shard-local views, true (unpadded) len
        self.tables = self._place(tables_l, tables_l[0].shape)
        self.postings = self._place(posts_l, (P_max,))
        self.miss_start = P_max
        self._init_hot(hot)

    def _place(self, parts, shape_tail):
        """[dp][shard] int32 views of per-shard uint32 arrays, each padded
        with zeros to shape_tail, on every device of its shard's column; a
        device that repeats in a column holds one copy."""
        shape_tail = tuple(shape_tail)
        cols = []
        for s, part in enumerate(parts):
            buf = np.zeros(shape_tail, dtype=np.uint32)
            buf[tuple(slice(0, d) for d in part.shape)] = part
            host = torch.from_numpy(buf.view(np.int32))
            cols.append({d: host.to(d) for d in
                         dict.fromkeys(r[s] for r in self.mesh.devices)})
        return [[cols[s][d] for s, d in enumerate(row)]
                for row in self.mesh.devices]

    def __getattr__(self, name):
        if name == "set_starts_np":
            # virtual-global set starts over the shard postings concat:
            # strictly increasing (per-shard starts + rising bases), with
            # the usual +sentinel duplicate (QueryCounts' searchsorted)
            parts = [np.asarray(o[:-1]).astype(np.int64) + int(b)
                     for o, b in zip(self.art.shard_set_offsets,
                                     self._post_bases[:-1])]
            total = int(self._post_bases[-1])
            v = np.concatenate(parts + [np.asarray([total, total])])
            self.set_starts_np = v
            return v
        raise AttributeError(name)

    # ------------------------------------------------------------------
    # Hot-set dense path (per-shard ops/hotset.py structures)
    # ------------------------------------------------------------------

    def _init_hot(self, enabled: bool) -> None:
        """Per-shard hot sets: each shard's longest postings sets, and on
        every device of its column M [H_max, P_pad] (float32 when
        H_max * P_pad * 4 <= M_BYTES_BUDGET, else bf16, as the JAX engine
        decides), MT bf16[P_pad, H_max] and the starts; a shard with no
        hot sets keeps threshold 2^30 and zero membership rows."""
        n = self.n_shards
        self.hot_thresh_np = np.full(n, 1 << 30, dtype=np.int32)
        self.hot_starts = self.M = self.MT = None
        sels = [hotset.select_hot_sets(self.sharded.set_offsets[s],
                                       self.art.num_proteins)
                if enabled else None for s in range(n)]
        if all(s is None for s in sels):
            return
        P_pad = -(-max(self.art.num_proteins, 1) // 128) * 128
        H_max = max(s[0].shape[0] for s in sels if s is not None)
        dtype = (torch.float32
                 if H_max * P_pad * 4 <= hotset.M_BYTES_BUDGET
                 else torch.bfloat16)
        starts = np.full((n, H_max), NO_START, dtype=np.int64)
        cols = []
        for s, sel in enumerate(sels):
            hh = rr = np.empty(0, np.int64)
            if sel is not None:
                hs, self.hot_thresh_np[s], _ = sel
                starts[s, : hs.shape[0]] = hs
                hh, rr = hotset.membership_pairs(
                    self._posts_local[s], self.sharded.set_offsets[s], hs)
            col = {}
            for d in dict.fromkeys(r[s] for r in self.mesh.devices):
                # built on the device by one scatter of the compact (hot
                # row, protein row) pairs: never materialized on the host
                M = torch.zeros((H_max, P_pad), dtype=dtype, device=d)
                M.index_put_((torch.from_numpy(hh).to(d),
                              torch.from_numpy(rr).to(d)),
                             torch.ones((), dtype=dtype, device=d))
                col[d] = (M, M.t().to(torch.bfloat16).contiguous(),
                          torch.from_numpy(starts[s]).to(d))
            cols.append(col)
        grid = self.mesh.devices
        self.M, self.MT, self.hot_starts = (
            [[cols[s][d][j] for s, d in enumerate(row)] for row in grid]
            for j in range(3))
        self.H_max, self.P_pad = H_max, P_pad

    def _hot_args(self):
        return (self.hot_thresh_np.tolist(), self.M, self.MT,
                self.hot_starts)

    # ------------------------------------------------------------------
    # dispatch / schedule / collect
    # ------------------------------------------------------------------

    def count_batch(self, seqs, sizes, k: int, positions: bool = False):
        return self.resolve_batch(self.dispatch_batch(seqs, sizes, k,
                                                      positions=positions))

    def resolve_batch(self, handle, min_top: int = 0):
        return self.collect_batch(self.schedule_batch(handle), min_top)

    def _pack(self, padded, width):
        wire = native.pack_queries(padded, width)
        if wire is None:
            wire = codec.pack_codes7(codec.pad_codes_batch(padded, width))
        return wire

    def _upload_rows(self, wire, n_np):
        """(codes, n_kmers) as [dp][shard] lists: every distinct device of
        the grid gets the whole batch in one staged copy, and each cell
        views its dp row's block (global dp row rank * dp_local + i)."""
        devs = self.mesh.distinct()
        on = dict(zip(devs, upload_each(
            [wire.view(np.int32), np.asarray(n_np, dtype=np.int64)], devs)))
        per = wire.shape[0] // self.dp
        base = self.mesh.rank * len(self.mesh.devices)
        codes, n_k = [], []
        for i, row in enumerate(self.mesh.devices):
            lo = (base + i) * per
            codes.append([on[d][0][lo:lo + per] for d in row])
            n_k.append([on[d][1][lo:lo + per] for d in row])
        return codes, n_k

    def dispatch_batch(self, seqs, sizes, k, positions: bool = False):
        """Phase 1: pack the batch, then probe + dedup + hot-split on every
        shard.  Nothing here waits for the card."""
        if not seqs:
            return None
        B0 = len(seqs)
        B = self.mult * _next_pow2(-(-max(B0, 16) // self.mult))
        padded = list(seqs) + [""] * (B - B0)
        L = _next_pow2(max(max(sizes), 8))
        width = L + KMER_SIZE - 1
        wire = self._pack(padded, width)
        n_np = np.zeros(B, dtype=np.int64)
        n_np[:B0] = sizes
        codes, n_k = self._upload_rows(wire, n_np)
        outs = sharded_totals(self.tables, self.hot_thresh_np, codes, n_k,
                              hash_log2=self.sharded.hash_log2,
                              miss_start=self.miss_start, width=width)
        return (outs, wire, n_np, list(seqs), list(sizes), k, L, positions)

    def _hot_g_max(self, L: int) -> int:
        """Largest hot-group width within the per-DEVICE dense budget (each
        shard device holds [G/dp, P_pad] f32 partial counts and a
        [G/dp, L, H] indicator)."""
        if self.hot_starts is None:
            return 1 << 30
        per_g = 4 * max(self.P_pad, L * self.H_max)
        g = self.dp * (HOT_DENSE_BYTES // per_g)
        return max(self._g_min(), 1 << max(0, int(g).bit_length() - 1))

    def _g_min(self) -> int:
        return max(16, self.mult)

    def _quantized_groups(self, cap: int, B: int, hot: bool,
                          L: int) -> List[int]:
        """Group widths schedule_batch can emit for (cap, hot, L): the
        engine.G_QUANTA quantization (mult-aligned), budget-clamped."""
        g_budget = max(self._g_min(),
                       1 << ((self.dp * MAX_EXPANSION_ELEMS // cap)
                             .bit_length() - 1))
        if hot:
            g_budget = min(g_budget, self._hot_g_max(L))
        gm = self._g_min()
        out = [gm]
        for g in G_QUANTA:
            if g > gm and g % self.mult == 0 and g <= min(g_budget, B):
                out.append(g)
        return out

    def schedule_batch(self, handle):
        """Group queries by their exact phase-1 totals and dispatch every
        phase-2 group (the JAX engine's scheduling policy without warmup
        cap pinning; group wire rows are sliced on the host, so groups
        freely mix rows across dp blocks).  The totals read is the one
        wait for the card."""
        if handle is None:
            return None
        (outs, wire, n_np, seqs, sizes, k, L, positions) = handle
        totals_h, _, hot_h = torch.stack(outs).cpu().numpy()
        B = wire.shape[0]
        B_real = len(sizes)

        slices = _LazyBatchSlices(self, seqs, sizes)
        k_full = _next_pow2(max(k, TOPK_MIN))
        results: Dict[int, QueryCounts] = {}

        G0 = min(self.GROUP_B, B)
        limit_g = min(_cap_floor(self.dp * MAX_EXPANSION_ELEMS // G0),
                      self.CAP_MAX)
        order = np.lexsort((-totals_h[:B_real],
                            hot_h[:B_real] == 0)).tolist()
        totals_l = totals_h.tolist()
        hot_l = (hot_h > 0).tolist()
        caps_l = np.maximum(np.minimum(_cap_bucket_vec(totals_h), limit_g),
                            self.CAP_MIN).tolist()
        normal: List[int] = []
        chunks: List[tuple] = []  # (rows, G_c, cap_c, hot)
        heavy: List[int] = []
        for i in order:
            t = totals_l[i]
            if t > self.CAP_MAX:
                results[i] = self._count_host_row(slices, i, sizes[i],
                                                  k_full)
            elif t > limit_g:
                heavy.append(i)
            else:
                normal.append(i)

        def any_hot(rows):
            return self.hot_starts is not None and any(
                hot_l[i] for i in rows)

        gm = self._g_min()
        for c0 in range(0, len(heavy), gm):
            rows = heavy[c0 : c0 + gm]
            cap_c = min(_next_pow2(max(totals_l[i] for i in rows)),
                        self.CAP_MAX)
            chunks.append((rows, gm, cap_c, any_hot(rows)))

        # the bulk: the shared cost-model chunker, legacy hot economics
        def groups_for(cap_c, hot0):
            return self._quantized_groups(cap_c, B, hot0, L)

        def hot_extra_rows():
            return max(self.P_pad, L * self.H_max) // 5000

        if self.hot_starts is None:
            hot_l = [False] * B
        chunks.extend(_plan_normal_chunks(normal, totals_l, hot_l, caps_l, 0,
                                          groups_for, hot_extra_rows))

        identity = (len(chunks) == 1 and not results
                    and len(chunks[0][0]) == B_real and chunks[0][1] == B)

        pending = []
        for rows, G_c, cap_c, hot in chunks:
            if identity:
                rows = list(range(B))
            pending.append(
                (rows, self._dispatch_group(wire, n_np, rows, G_c, cap_c,
                                            k_full, L, positions, hot,
                                            identity=identity)))
        return (pending, results, sizes, B_real, slices)

    def collect_batch(self, sched, min_top: int = 0):
        if sched is None:
            return []
        pending, results, sizes, B_real, slices = sched
        return _finalize_pending(pending, results, sizes, B_real, slices,
                                 self, min_top)

    def _pos_on_device(self, cap: int, k_eff: int, L: int, G: int) -> bool:
        # per-shard bitmaps run over [G/dp, cap, k]; the merged expansion
        # each finalizing device touches is n_shards * cap wide
        return search_engine._positions_on_device(
            cap * self.n_shards, k_eff, L, max(G // self.dp, 1))

    def _dispatch_group(self, wire, n_np, rows, G: int, cap: int,
                        k_full: int, L: int, positions: bool, hot: bool,
                        identity: bool = False):
        """Upload one group's wire rows (padded to G) and enqueue it;
        returns the item _finalize_pending reads: (outputs, pos_dev)."""
        if identity:
            wire2, n2 = wire, n_np
        else:
            wire2 = np.zeros((G,) + wire.shape[1:], wire.dtype)
            n2 = np.zeros(G, dtype=np.int64)
            wire2[: len(rows)] = wire[rows]
            n2[: len(rows)] = n_np[rows]
        width = L + KMER_SIZE - 1  # residue width (wire.shape[1] is packed)
        k2 = k_full if hot else min(k_full, cap * self.n_shards)
        pos_dev = positions and self._pos_on_device(
            cap, k_full if hot else k2, L, G)
        codes, n_k = self._upload_rows(wire2, n2)
        _tally(self.stats, "hot" if hot else "cold")
        outs = sharded_group(
            self.tables, self.postings, codes, n_k,
            hash_log2=self.sharded.hash_log2, cap=cap, k=k2, width=width,
            positions=pos_dev, hot=self._hot_args() if hot else None,
            # multi-process: every process's collect_batch reads the
            # whole group's outputs
            replicate_out=self.mesh.world > 1)
        return outs, pos_dev

    # ------------------------------------------------------------------
    # warmup / host fallback
    # ------------------------------------------------------------------

    def warmup(self, batch_sizes=(16, 2048), lengths=(64, 128, 256, 512),
               positions=(False, True), caps=None) -> None:
        """Run the serving shape grid once on synthetic inputs, in the JAX
        sharded engine's order (parallel/dist.py:543-572): one
        dispatch_batch -> resolve_batch per (positions, B, L), then per
        (positions, hot, cap, L) one group of G empty rows through
        _dispatch_group(..., identity=True) for each width G that
        _quantized_groups(cap, max(batch_sizes), hot, L) allows.  The
        contract of SearchEngine.warmup holds: the calling thread, each
        device's current stream (every tensor names its device), no
        emptied cache, stats unchanged, the same answers, the same error
        policy.

        On a multi-process mesh every group step joins comm.dp_all_gather,
        so every process must call warmup with the same arguments at the
        same point of its batch sequence: each then runs the same grid in
        the same order.  There a refused shape or an out-of-memory error
        raises instead of being skipped or stopping the warmup, since a
        process that left out a step would leave its peers waiting in the
        gather."""
        caps = tuple(caps) if caps else self.WARM_CAPS
        strict = self.mesh.world > 1
        with _warming():
            if not _warm_batches(self, batch_sizes, lengths, positions,
                                 strict):
                return
            B_max = max(batch_sizes)
            k_full = _next_pow2(max(10, TOPK_MIN))
            hots = (False, True) if self.hot_starts is not None else (False,)
            for pos in positions:
                for hot in hots:
                    for capv in caps:
                        for L in lengths:
                            for G in self._quantized_groups(capv, B_max, hot,
                                                            L):
                                if not _warm_step(
                                        f"group {'hot' if hot else 'cold'} "
                                        f"G={G} L={L} cap={capv} "
                                        f"positions={pos}",
                                        lambda: self._dispatch_group(
                                            self._pack([""] * G,
                                                       L + KMER_SIZE - 1),
                                            np.zeros(G, np.int64),
                                            list(range(G)), G, capv, k_full,
                                            L, pos, hot, identity=True),
                                        strict):
                                    return

    # ------------------------------------------------------------------
    # host fallback
    # ------------------------------------------------------------------

    def _host_bitmaps_np(self, qc, hit_rows):
        """Host position bitmaps; shard-built artifacts aggregate per-shard
        probes (a split set's sub-slices live on every shard: membership is
        the OR over shards).  The global-artifact layout keeps the base
        class's path (its host probe resolves whole sets)."""
        if not getattr(self.art, "index_shards", 0):
            return super()._host_bitmaps_np(qc, hit_rows)
        from ..ops.count import member_np

        hits = np.asarray(list(hit_rows), dtype=np.uint32)
        if hits.size == 0 or qc._n_kmers == 0:
            return {}
        if qc._offs is not None and getattr(qc._offs, "ndim", 1) == 2:
            offs_all, lens_all = qc._offs, qc._lens
        else:
            offs_all = qc._batch.host()[:, qc._row, : qc._n_kmers].astype(
                np.int64)
            starts = self.set_starts_np
            ids = np.searchsorted(starts, offs_all, side="left")
            lens_all = starts[ids + 1] - starts[ids]
        found = None
        for s in range(offs_all.shape[0]):
            f = member_np(self.postings_np, offs_all[s], lens_all[s], hits)
            found = f if found is None else (found | f)
        return {int(h): found[j] for j, h in enumerate(hits)}

    def _count_host_row(self, slices: "_LazyBatchSlices", i: int,
                        n_kmers: int, k: int):
        """Unbounded host fallback (np.bincount) for postings-heavy
        queries, over the GLOBAL artifact (bit-identical to the
        single-device one).  Shard-built artifacts probe per shard
        (slices.stacked): each k-mer's set is the UNION of its per-shard
        sub-slices (split sets live on every shard), so segs accumulate
        over the shard axis too.  Starts and keys are both int64."""
        if slices.stacked:
            offs = slices.host()[:, i, :n_kmers].astype(np.int64)  # [S, n]
        else:
            offs = slices.host()[i, :n_kmers].astype(np.int64)[None]
        starts = self.set_starts_np
        ids = np.searchsorted(starts, offs, side="left")
        lens = starts[ids + 1] - starts[ids]
        segs = [self.postings_np[int(o): int(o) + int(l)]
                for o, l in zip(offs.ravel(), lens.ravel()) if l > 0]
        if not slices.stacked:  # 1-D contract of the base-class host paths
            offs, lens = offs[0], lens[0]
        if segs:
            rows = np.concatenate(segs)
            bc = np.bincount(rows)
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


class _ConcatPostings:
    """Read-only virtual concatenation of per-shard postings arrays
    (shard-built artifacts never materialize a global postings array: the
    point of index_db(n_shards > 1) is that the global size exceeds uint32
    addressing or host RAM).  Supports exactly the access patterns of the
    host fallbacks: len(), contiguous slices (a shard-LOCAL postings slice
    -- a whole owned set or one shard's sub-slice of a split set -- never
    crosses a shard boundary, index/build.py), and fancy integer indexing
    (ops/count.member_np's binary search probes)."""

    def __init__(self, parts: List[np.ndarray]):
        self.parts = parts
        self.bases = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum([p.shape[0] for p in parts], out=self.bases[1:])
        self.dtype = parts[0].dtype if parts else np.dtype(np.uint32)

    def __len__(self) -> int:
        return int(self.bases[-1])

    @property
    def shape(self):
        return (len(self),)

    def _shard_of(self, flat_idx: np.ndarray) -> np.ndarray:
        # side="right" skips empty shards (repeated bases) correctly
        s = np.searchsorted(self.bases, flat_idx, side="right") - 1
        return np.clip(s, 0, len(self.parts) - 1)

    def __getitem__(self, key):
        if isinstance(key, slice):
            o = int(key.start or 0)
            e = len(self) if key.stop is None else min(int(key.stop),
                                                       len(self))
            if e <= o:
                return np.empty(0, dtype=self.dtype)
            s = int(self._shard_of(np.asarray([o]))[0])
            base = int(self.bases[s])
            return self.parts[s][o - base : e - base]
        idx = np.asarray(key, dtype=np.int64)
        sh = self._shard_of(idx.ravel())
        local = idx.ravel() - self.bases[sh]
        out = np.empty(idx.size, dtype=self.dtype)
        for s, p in enumerate(self.parts):
            m = sh == s
            if m.any():
                out[m] = p[local[m]]
        return out.reshape(idx.shape)


class _LazyBatchSlices:
    """Per-batch lazy global k-mer -> slice-start resolution for position
    lookups and the host count: one vectorized host probe of the global
    artifact table for the whole batch, computed only if some query needs
    it.

    Shard-built artifacts have no global table, so every shard table is
    probed and `stacked` is True: host() is then [n_shards, B, L], one row
    of rebased slice starts per shard.  A k-mer can hit on EVERY shard --
    long sets split contiguously across all of them (mesh.split_set_mask)
    -- so consumers sum counts / OR bitmaps over axis 0."""

    def __init__(self, engine: ShardedSearchEngine, seqs, sizes):
        self._engine = engine
        self._seqs = seqs
        self._sizes = sizes
        self._offs = None
        self.stacked = bool(getattr(engine.art, "index_shards", 0))

    def host(self) -> np.ndarray:
        if self._offs is None:
            from ..index.hashtable import CuckooTable, lookup_np

            eng = self._engine
            miss = int(eng.set_starts_np[-1])  # global P -> empty-set id
            L = max(self._sizes) if self._sizes else 1
            width = L + KMER_SIZE - 1
            codes = codec.pad_codes_batch(self._seqs, width)
            kmers = codec.encode_kmers_batch(codes.astype(np.int32))  # [B, L]
            flat = kmers.reshape(-1)
            lane = np.arange(L)[None, :]
            sizes = np.asarray(self._sizes)[:, None]
            in_q = lane < sizes
            if self.stacked:
                if not hasattr(eng, "_ht"):
                    eng._ht = [CuckooTable(table=np.asarray(t),
                                           log2=eng.art.hash_log2)
                               for t in eng.art.shard_tables]
                offs = np.full((len(eng._ht),) + kmers.shape, miss,
                               dtype=np.int64)
                for s, ht in enumerate(eng._ht):
                    st_s, ln_s = lookup_np(ht, flat, miss_start=0)
                    hit = (ln_s > 0).reshape(kmers.shape) & in_q
                    starts = (st_s.astype(np.int64).reshape(kmers.shape)
                              + int(eng._post_bases[s]))
                    offs[s][hit] = starts[hit]
                self._offs = offs
            else:
                if not hasattr(eng, "_ht"):
                    eng._ht = CuckooTable(
                        table=np.asarray(eng.art.hash_table),
                        log2=eng.art.hash_log2)
                starts, _ = lookup_np(eng._ht, flat, miss_start=miss)
                starts = starts.reshape(kmers.shape).astype(np.int64)
                self._offs = np.where(in_q, starts, np.int64(miss))
        return self._offs
