"""Search flows on the torch engine (kaamer_tpu/search/pipeline.py).

The host half is the JAX package's, copied unchanged:

  protein:    query FASTA -> length-bucketed device batches (_batched),
              kept `depth` in flight on the engine's dispatch/schedule/
              prefetch/collect protocol (_pipelined) -> filter/format
              (search/results.py)
  nucleotide: per record, 6-frame ORF extraction (search/orf.py) -> ORF
              batches dispatched with positions=True -> per-ORF MinKMatch
              gate (min_top, in the engine) -> start-codon refinement ->
              filter/format; the plain-TSV shape takes the lean path
              (_nucleotide_search_lean_tsv), which writes row bytes
  fastq:      like nucleotide over read records

-aln aligns the kept hits in flushes of ALIGN_FLUSH_PAIRS pairs on the
engine's device (ops/swalign.py), translated hits included.
"""

from __future__ import annotations

from collections import deque
from operator import itemgetter
from typing import Dict, Iterator, List

import numpy as np

from ..io_formats.readers import (QueryLocation, QueryRecord,
                                  read_fasta_queries, read_fastq_queries)
from . import results as fmt
from ..ops import swalign
from .engine import QueryCounts, SearchEngine, _next_pow2
from .options import (DNA_QUERY, NUCLEOTIDE, PROTEIN, PROTEIN_QUERY, READS,
                      SearchOptions)
from .orf import get_orf_tuples_batch, set_best_start_codon
from .results import Hit, QueryResult

KMER_SIZE = 7
# Queries per device dispatch (pipeline.py:42-46).
BATCH_MAX = 2048
# (query, subject) pairs per -aln device batch (pipeline.py:531).
ALIGN_FLUSH_PAIRS = 256


def run_search(engine: SearchEngine, opts: SearchOptions,
               cancel=None) -> Iterator[bytes]:
    """Full response stream (header, rows, epilogue) of a search, byte for
    byte the JAX package's run_search.  cancel: optional zero-arg callable
    polled between batches."""
    db_stats = engine.art.stats
    if opts.OutFormat == "tsv":
        yield fmt.tsv_header(opts, db_stats).encode()
    else:
        yield fmt.json_prologue(opts, db_stats).encode()

    # translated-read fast path: the plain TSV shape (no positions, no
    # annotations, no alignment) needs only entry-id strings and a handful
    # of scalars per hit (pipeline.py:65-75)
    if (LEAN_NT_TSV and opts.OutFormat == "tsv" and not opts.Align
            and not opts.ExtractPositions and not opts.Annotations
            and opts.SequenceType in (NUCLEOTIDE, READS)):
        yield from _nucleotide_search_lean_tsv(
            engine, opts, fastq=opts.SequenceType == READS, cancel=cancel)
        return

    results = iter_query_results(engine, opts, cancel=cancel)
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


def iter_query_results(engine: SearchEngine, opts: SearchOptions,
                       cancel=None) -> Iterator[QueryResult]:
    if opts.SequenceType == PROTEIN:
        yield from protein_search(engine, opts, cancel=cancel)
    elif opts.SequenceType == NUCLEOTIDE:
        yield from nucleotide_search(engine, opts, fastq=False, cancel=cancel)
    else:
        yield from nucleotide_search(engine, opts, fastq=True, cancel=cancel)


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


def _orf_item_stream(records, gcode: int):
    """Per-ORF work items (seq, n_kmers, record, sp, ep, plus, alts):
    plain tuples, because most ORFs are discarded by the MinKMatch gate
    downstream and never need QueryRecord/Location objects (object
    construction dominated the fastq host profile).  Records are
    ORF-scanned in chunks so the native batch scanner amortizes its call
    overhead."""
    # large chunks amortize the native scanner's per-call thread spawn
    # (~1 ms); 2048 reads scan in a few ms and stay well ahead of the
    # device pipeline
    CHUNK = 2048
    pending = []

    def emit(pending):
        # min_kmers=1: unsearchable ORFs are gated vectorized inside the
        # scanner, before any Python string is built for them
        batch = get_orf_tuples_batch([r.Sequence for r in pending],
                                     gcode, min_kmers=1)
        for rec, orfs in zip(pending, batch):
            for seq, n, sp, ep, plus, alts in orfs:
                yield (seq, n, rec, sp, ep, plus, alts)

    for rec in records:
        pending.append(rec)
        if len(pending) >= CHUNK:
            yield from emit(pending)
            pending = []
    if pending:
        yield from emit(pending)


def _nt_records(opts: SearchOptions, fastq: bool):
    if fastq:
        return read_fastq_queries(opts.File)
    return read_fasta_queries(opts.File, is_protein=False)


def nucleotide_search(
    engine: SearchEngine, opts: SearchOptions, fastq: bool, cancel=None
) -> Iterator[QueryResult]:
    records = _nt_records(opts, fastq)

    def orf_items():
        yield from _orf_item_stream(records, opts.GeneticCode)

    ext_ids = np.asarray(engine.art.protein_ids)

    k = max(opts.MaxResults, 1)
    # When the caller never reads position bitmaps (tsv without -positions;
    # they print as N/A), the only consumer is set_best_start_codon, which
    # reads ONLY the top-tie hits' bitmaps -- so skip materializing the
    # per-hit bitmap dict for the other hits (each entry is a slice + dict
    # insert, ~25% of read-search finalization time).  JSON output and
    # -positions serialize PositionHits and take the full dict.
    lean_positions = opts.OutFormat != "json" and not opts.ExtractPositions

    for batch, counts in _pipelined(engine,
                                    _batched(orf_items(),
                                             size_of=itemgetter(1)),
                                    k, positions=True, cancel=cancel,
                                    seq_of=itemgetter(0),
                                    size_of=itemgetter(1),
                                    min_top=opts.MinKMatch):
        for item, qc in zip(batch, counts):
            # top-hit gate (search_nucleotide.go:116): min_top gates rows
            # vectorized in the engine (returned as None, bitmaps never
            # unpacked); host-fallback rows bypass the engine gate and are
            # re-checked here
            if qc is None or qc.counts.size == 0 \
                    or int(qc.counts[0]) < opts.MinKMatch:
                continue

            seq, n, rec, sp, ep, plus, alts = item
            # the ORF's alternative-starts list is handed over without a
            # copy: set_best_start_codon rebinds (not mutates) the attribute
            q = QueryRecord(
                Sequence=seq,
                Name=rec.Name,
                SizeInKmer=n,
                Type=DNA_QUERY,
                Location=QueryLocation(
                    StartPosition=sp, EndPosition=ep, PlusStrand=plus,
                    StartsAlternative=alts,
                ),
                Contig=rec.Contig if not fastq else "",
            )
            # hits below MinKMatch are dropped by filter_results regardless
            # (search.go:189-220, monotone in Kmatch over the count-desc
            # list), so trim BEFORE building Hit objects and bitmaps --
            # most of the per-ORF host cost scales with the hit count
            m = int((qc.counts >= opts.MinKMatch).sum())
            keys = ext_ids[qc.hit_rows[:m]].tolist()
            kms = qc.counts[:m].tolist()
            hits = [Hit(Key=key, Kmatch=km) for key, km in zip(keys, kms)]
            # Positions are always extracted for translated queries
            # (search.go:416); compute them for every reported hit candidate.
            # Bitmaps stay numpy bool arrays end to end (argmax start-codon
            # scan, vectorized run formatting, tolist only at JSON time).
            if qc._bitmaps is not None:
                # device bitmaps are prefix-aligned with hit_rows: row j of
                # the [k, L] bool array IS hit_rows[j]'s bitmap
                bmq = qc._bitmaps
                if lean_positions:
                    t = 1  # ties at the top count (counts are desc)
                    while t < len(kms) and kms[t] == kms[0]:
                        t += 1
                    position_hits = {key: bmq[j, :n]
                                     for j, key in enumerate(keys[:t])}
                else:
                    position_hits = {key: bmq[j, :n]
                                     for j, key in enumerate(keys)}
            else:  # host-fallback queries carry no device bitmaps
                rows = [int(r) for r in qc.hit_rows[:m]]
                bitmaps_rows = engine.position_bitmaps_np(qc, rows)
                position_hits = {
                    int(ext_ids[r]): bm for r, bm in bitmaps_rows.items()
                }

            qr = QueryResult(Query=q, Hits=hits,
                             PositionHits=position_hits, HitEntries={})
            if len(alts) > 1:  # with <=1 alternative it provably no-ops
                set_best_start_codon(
                    qr.Query,
                    list(zip(keys, kms)),
                    qr.PositionHits,
                )
            fmt.filter_results(qr, opts)
            if qr.Hits:
                if lean_positions:
                    qr.PositionHits = {}
                else:
                    # drop bitmaps of proteins outside the kept hit list
                    # (the reference deletes them in FilterResults)
                    kept = {h.Key for h in qr.Hits}
                    qr.PositionHits = {
                        k: v for k, v in qr.PositionHits.items() if k in kept
                    }
                _fetch_entries(engine, qr)
                yield qr


# Kill switch for the lean translated-read TSV path (tests force the
# generic path through here to assert byte-identity).
LEAN_NT_TSV = True


def _nucleotide_search_lean_tsv(engine: SearchEngine, opts: SearchOptions,
                                fastq: bool, cancel=None) -> Iterator[bytes]:
    """Translated search for the plain-TSV shape, emitting row BYTES
    directly: same gate (search_nucleotide.go:116), start-codon refinement
    (dna.go:198-272 incl. the shared exit-flag quirk), FilterResults prefix
    semantics (search.go:189-220) and row layout (search.go:497-607) as the
    generic path -- minus all per-ORF object construction.  Byte-identity
    with the generic path is asserted by tests/test_torch_translated.py."""
    records = _nt_records(opts, fastq)
    art = engine.art
    min_km = opts.MinKMatch
    min_ratio = opts.MinKRatio
    max_res = opts.MaxResults
    k = max(max_res, 1)

    # entry-id strings, not Protein records: the only per-hit DB read here
    eids: Dict[int, str] = {}

    def eid(row: int) -> str:
        v = eids.get(row)
        if v is None:
            if len(eids) >= _ENTRY_CACHE_MAX:
                eids.clear()
            v = eids[row] = art.entry_id(row)
        return v

    pct = fmt._f32_pct
    for batch, counts in _pipelined(engine,
                                    _batched(_orf_item_stream(
                                        records, opts.GeneticCode),
                                        size_of=itemgetter(1)),
                                    k, positions=True, cancel=cancel,
                                    seq_of=itemgetter(0),
                                    size_of=itemgetter(1),
                                    min_top=min_km):
        parts: List[str] = []
        for item, qc in zip(batch, counts):
            if qc is None or qc.counts.size == 0 \
                    or int(qc.counts[0]) < min_km:
                continue
            seq, size, rec, sp, ep, plus, alts = item
            kml = qc.counts.tolist()
            # start-codon refinement (set_best_start_codon semantics on raw
            # arrays): find the first matched k-mer among top-tie hits'
            # bitmaps, honoring the reference's shared exit flag -- later
            # tie hits are only consulted at position 0
            if len(alts) > 1:
                top = kml[0]
                first_pos = 999999999
                exit_flag = False
                bmq = qc._bitmaps
                for j, km in enumerate(kml):
                    if km < top:
                        break
                    if bmq is not None:
                        bm = bmq[j, :size]
                    else:  # host-fallback rows carry no device bitmaps
                        r = int(qc.hit_rows[j])
                        bm = engine.position_bitmaps_np(qc, [r]).get(
                            r, np.zeros(0, bool))
                    if bm.size == 0:
                        continue
                    if exit_flag:
                        if bm[0]:
                            first_pos = 0
                    else:
                        i = int(bm.argmax())
                        if bm[i]:
                            first_pos = min(first_pos, i)
                            exit_flag = True
                best_start = alts[0]
                for s in alts:
                    if s <= first_pos:
                        best_start = s
                    else:
                        break
                if best_start != alts[0]:
                    sp = sp + 3 * best_start if plus else sp - 3 * best_start
                    seq2 = seq[best_start:]
                    size = len(seq2) - KMER_SIZE + 1
                    if seq2.endswith("*"):
                        size -= 1
            # FilterResults prefix + MaxResults cap
            good = 0
            for km in kml:
                if (km / size if size else 0.0) < min_ratio or km < min_km:
                    break
                good += 1
            good = min(good, max_res)
            if not good:
                continue
            qname = rec.Name.split(" ", 1)[0]
            rows_np = qc.hit_rows
            tail = f"\tN/A\t{sp}\t{ep}\t1\tN/A\n"
            for j in range(good):
                km = kml[j]
                parts.append(f"{qname}\t{eid(int(rows_np[j]))}\t"
                             f"{pct(km, size)}\t{size}\t{km}{tail}")
        if parts:
            yield "".join(parts).encode()


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
