"""Protein search flow on the torch engine (kaamer_tpu/search/pipeline.py).

The protein path is the JAX package's, copied unchanged: queries are read
and bucketed by length (_batched), kept `depth` batches in flight on the
engine's dispatch/schedule/prefetch/collect protocol (_pipelined),
filtered and formatted (search/results.py), and -aln aligns the kept hits
in flushes of ALIGN_FLUSH_PAIRS pairs on the engine's device
(ops/swalign.py).  Nucleotide and FASTQ search are not ported yet.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List

import numpy as np

from ..io_formats.readers import QueryRecord, read_fasta_queries
from . import results as fmt
from ..ops import swalign
from .engine import QueryCounts, SearchEngine, _next_pow2
from .options import PROTEIN, PROTEIN_QUERY, SearchOptions
from .results import Hit, QueryResult

# Queries per device dispatch (pipeline.py:42-46).
BATCH_MAX = 2048
# (query, subject) pairs per -aln device batch (pipeline.py:531).
ALIGN_FLUSH_PAIRS = 256


def run_search(engine: SearchEngine, opts: SearchOptions,
               cancel=None) -> Iterator[bytes]:
    """Full response stream (header, rows, epilogue) of a protein search,
    byte for byte the JAX package's run_search.  cancel: optional zero-arg
    callable polled between batches."""
    if opts.SequenceType != PROTEIN:
        raise NotImplementedError(
            "nucleotide and FASTQ search are not ported yet (ROADMAP "
            "Queue 1 item 7)")
    db_stats = engine.art.stats
    if opts.OutFormat == "tsv":
        yield fmt.tsv_header(opts, db_stats).encode()
    else:
        yield fmt.json_prologue(opts, db_stats).encode()

    results = protein_search(engine, opts, cancel=cancel)
    if opts.Align:
        results = _aligned_results(engine, results, opts)

    first = True
    for qr in results:
        if opts.OutFormat == "json":
            data = fmt.json_result(qr, opts.Align).encode()
            yield data if first else b"," + data
            first = False
        else:
            rows = fmt.tsv_rows(qr, opts, db_stats)
            if rows:
                yield "".join(rows).encode()

    if opts.OutFormat == "json":
        yield fmt.JSON_EPILOGUE.encode()


def _batched(queries, size_of=lambda q: q.SizeInKmer):
    """Group queries into batches of similar length (same power-of-two
    k-mer-count bucket) to limit padding waste."""
    buckets: Dict[int, List] = {}
    for q in queries:
        b = _next_pow2(max(size_of(q), 8))
        lst = buckets.setdefault(b, [])
        lst.append(q)
        if len(lst) >= BATCH_MAX:
            yield lst
            buckets[b] = []
    for lst in buckets.values():
        if lst:
            yield lst


def _pipelined(engine: SearchEngine, batches, k: int, depth: int = 4,
               positions: bool = False, cancel=None,
               seq_of=lambda q: q.Sequence, size_of=lambda q: q.SizeInKmer,
               min_top: int = 0):
    """Keep `depth` batches in flight on the device while finalizing earlier
    ones on the host (overlaps upload/compute/fetch).

    cancel (optional callable) is polled before each dispatch; once true, no
    further queries are read or dispatched and in-flight batches are drained
    without yielding -- the serving analogue of the reference's cancelQuery
    flag checked by its readers and workers (search.go:157-166, 280-282).

    seq_of/size_of extract sequence and k-mer count from a batch element
    (QueryRecord for protein search; plain tuples on the ORF fast path).

    min_top > 0: queries whose top count falls below it come back as None
    instead of a QueryCounts (vectorized discard in the engine; the
    translated-search MinKMatch gate, search_nucleotide.go:116)."""
    # three-stage protocol when the engine supports it: schedule (dispatch
    # the phase-2 chunks) one batch behind the newest dispatch, so the
    # device queue never drains while the host finalizes older batches
    schedule = getattr(engine, "schedule_batch", None)
    collect = getattr(engine, "collect_batch", None)
    if schedule is None or collect is None:
        schedule, collect = (lambda h: h), engine.resolve_batch
    # certificate re-runs dispatch as early as possible, not at collect
    # time (a lazy re-run queues behind every later batch's device work;
    # engine.prefetch_batch docstring)
    prefetch = getattr(engine, "prefetch_batch", lambda s, m=0: s)

    pending = deque()  # entries [batch, handle, sched-or-None]
    cancelled = False
    for batch in batches:
        if cancel is not None and cancel():
            cancelled = True
            break
        handle = engine.dispatch_batch(
            [seq_of(q) for q in batch], [size_of(q) for q in batch], k=k,
            positions=positions,
        )
        pending.append([batch, handle, None])
        if len(pending) >= 2 and pending[-2][2] is None:
            pending[-2][2] = schedule(pending[-2][1])
        if len(pending) >= 3 and pending[-3][2] is not None:
            pending[-3][2] = prefetch(pending[-3][2], min_top)
        if len(pending) >= depth:
            b, h, s = pending.popleft()
            yield b, collect(s if s is not None else schedule(h), min_top)
    while pending:
        b, h, s = pending.popleft()
        res = collect(s if s is not None else schedule(h), min_top)
        if not cancelled:
            yield b, res


def protein_search(engine: SearchEngine, opts: SearchOptions,
                   cancel=None) -> Iterator[QueryResult]:
    def queries():
        for q in read_fasta_queries(opts.File, is_protein=True):
            q.Type = PROTEIN_QUERY
            # The reference kills the whole worker on a short query
            # (search_protein.go:74-76, a bug); we skip just the query.
            if q.SizeInKmer < 7:
                continue
            yield q

    k = max(opts.MaxResults, 1)
    for batch, counts in _pipelined(engine, _batched(queries()), k,
                                    positions=opts.ExtractPositions,
                                    cancel=cancel):
        for q, qc in zip(batch, counts):
            if qc is None:  # engines only return None under min_top gating
                continue
            qr = _build_result(engine, q, qc, opts,
                               need_positions=opts.ExtractPositions)
            if qr is not None and qr.Hits:
                yield qr


def _build_result(
    engine: SearchEngine,
    q: QueryRecord,
    qc: QueryCounts,
    opts: SearchOptions,
    need_positions: bool,
) -> QueryResult:
    ext_ids = np.asarray(engine.art.protein_ids)
    keys = ext_ids[np.asarray(qc.hit_rows).astype(np.int64)].tolist()
    hits = [Hit(Key=key, Kmatch=km)
            for key, km in zip(keys, np.asarray(qc.counts).tolist())]
    qr = QueryResult(Query=q, Hits=hits, PositionHits={}, HitEntries={})
    fmt.filter_results(qr, opts)
    if not qr.Hits:
        return qr
    if need_positions:
        rows = [int(r) for r, c in zip(qc.hit_rows, qc.counts)][: len(qr.Hits)]
        bitmaps = engine.position_bitmaps_np(qc, rows)
        qr.PositionHits = {
            int(ext_ids[r]): bm for r, bm in bitmaps.items()
        }
    _fetch_entries(engine, qr)
    return qr


# Hit Protein records are parsed from the artifact blob (JSON decode per
# row); a bounded per-engine cache amortizes repeated hits across queries.
_ENTRY_CACHE_MAX = 65536


def _fetch_entries(engine: SearchEngine, qr: QueryResult) -> None:
    art = engine.art
    cache = getattr(engine, "_entry_cache", None)
    if cache is None:
        cache = engine._entry_cache = {}
    for h in qr.Hits:
        if h.Key in qr.HitEntries:
            continue
        prot = cache.get(h.Key)
        if prot is None:
            row = art.row_for_id(h.Key)
            if row is None:
                continue
            prot = art.protein(row)
            if len(cache) >= _ENTRY_CACHE_MAX:
                cache.clear()
            cache[h.Key] = prot
        qr.HitEntries[h.Key] = prot


def _aligned_results(engine: SearchEngine, results, opts: SearchOptions):
    """Alignment step batched across the result stream
    (pipeline.py:534-559): buffer results until ALIGN_FLUSH_PAIRS (query,
    subject) pairs accumulate, enqueue that batch on the engine's device,
    keep collecting results while it runs, and resolve a flush once the
    next one is enqueued.  Each result's hits re-sort by bit score desc;
    results keep their order."""
    pending = deque()
    buf: List[QueryResult] = []
    n_pairs = 0
    for qr in results:
        buf.append(qr)
        n_pairs += sum(1 for h in qr.Hits if h.Key in qr.HitEntries)
        if n_pairs >= ALIGN_FLUSH_PAIRS:
            pending.append(_align_dispatch(engine, buf, opts))
            buf, n_pairs = [], 0
            if len(pending) >= 2:
                yield from _align_resolve(pending.popleft())
    if buf:
        pending.append(_align_dispatch(engine, buf, opts))
    while pending:
        yield from _align_resolve(pending.popleft())


def _align_dispatch(engine: SearchEngine, buf: List[QueryResult],
                    opts: SearchOptions):
    pairs = []
    hit_refs = []
    for qr in buf:
        for h in qr.Hits:
            if h.Key in qr.HitEntries:
                pairs.append((qr.Query.Sequence,
                              qr.HitEntries[h.Key].Sequence))
                hit_refs.append(h)
    handle = None
    if pairs:
        try:
            handle = swalign.align_batch_dispatch(
                pairs, engine.art.stats, opts.SubMatrix, opts.GapOpen,
                opts.GapExtend, device=engine.device)
        except swalign.NoMatrixError:
            pass  # hits keep zero alignments (reference's untouched struct)
    return buf, hit_refs, handle


def _align_resolve(flush):
    buf, hit_refs, handle = flush
    if handle is not None:
        for h, res in zip(hit_refs, swalign.align_batch_resolve(handle)):
            h.Alignment = res
    for qr in buf:
        # hits without a DB entry keep Alignment=None (zero BitScore); the
        # sort is stable, so zero-score hits keep their kmatch order
        qr.Hits.sort(key=lambda h: -h.Alignment.BitScore if h.Alignment
                     else 0.0)
        yield qr
