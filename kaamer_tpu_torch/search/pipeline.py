"""Protein search flow on the torch engine (kaamer_tpu/search/pipeline.py).

run_search reuses the JAX package's protein_search (reading, batching,
filtering, entry fetches) and its TSV/JSON formatters, which only call the
engine's dispatch/schedule/collect protocol.  The -aln step is this
module's own: the JAX package's _aligned_results is bound to
kaamer_tpu.ops.swalign, which dispatches to the Pallas kernel.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, List

from kaamer_tpu.search import results as fmt
from kaamer_tpu.search.options import PROTEIN, SearchOptions
from kaamer_tpu.search.pipeline import ALIGN_FLUSH_PAIRS, protein_search
from kaamer_tpu.search.results import QueryResult

from ..ops import swalign
from .engine import SearchEngine


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
