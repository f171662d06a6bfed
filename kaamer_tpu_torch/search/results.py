"""Hit filtering and output formatting (TSV / JSON).

Byte-format parity with the reference writer (search.go:472-742):

- FilterResults semantics (search.go:189-220): hits sorted by k-match desc;
  drop hits with kmatch/SizeInKmer < MinKRatio or kmatch < MinKMatch; cap at
  MaxResults.
- TSV headers and row layouts per search.go:636-692 and 497-607, including
  the quirks: the no-align "GapOpen" column holds the comma count of the
  positions string (search.go:520-523), SStart is the literal "1", SEnd is
  the subject length only with -ann.
- FormatPositionsToString (search.go:694-742) including its end-position
  off-by-one: a run terminated inside the query reports the 1-based position
  of the first non-matching k-mer as its end.
- JSON mirrors Go json.Marshal of the reference structs: field order is
  struct order, map keys sort lexicographically, protobuf-derived structs
  (Protein) honor omitempty, and the zero Alignment struct is embedded when
  alignment is off.

Ranking tie-break: the reference inherits Go map iteration order for equal
k-match (search.go:136-150, nondeterministic); we fix count desc, id asc.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..records import KStats, Protein
from ..io_formats.readers import QueryRecord
from .options import PROTEIN, SearchOptions

KMER_SIZE = 7


@dataclass(slots=True)
class AlignmentResult:
    """Mirrors reference align.AlignmentResult (align/align.go:17-31)."""

    Identity: float = 0.0
    Similarity: float = 0.0
    Length: int = 0
    Mismatches: int = 0
    GapOpenings: int = 0
    Raw: int = 0
    BitScore: float = 0.0
    EValue: float = 0.0
    AlnString: str = ""
    QueryStart: int = 0
    QueryEnd: int = 0
    SubjectStart: int = 0
    SubjectEnd: int = 0

    def to_json_obj(self) -> dict:
        return {
            "Identity": _jsnum(self.Identity),
            "Similarity": _jsnum(self.Similarity),
            "Length": self.Length,
            "Mismatches": self.Mismatches,
            "GapOpenings": self.GapOpenings,
            "Raw": self.Raw,
            "BitScore": _jsnum(self.BitScore),
            "EValue": _jsnum(self.EValue),
            "AlnString": self.AlnString,
            "QueryStart": self.QueryStart,
            "QueryEnd": self.QueryEnd,
            "SubjectStart": self.SubjectStart,
            "SubjectEnd": self.SubjectEnd,
        }


def _jsnum(x: float):
    """Emit integral floats the way Go does (0, not 0.0)."""
    if x == int(x) and abs(x) < 1e15:
        return int(x)
    return x


@dataclass(slots=True)
class Hit:
    Key: int  # external protein id
    Kmatch: int
    # lazy: None until -aln fills it (a zero AlignmentResult is 13 fields;
    # constructing one per Hit measured ~10% of read-search host time).
    # Formatters substitute _ZERO_ALIGNMENT, matching the reference's
    # embedded zero struct when alignment is off.
    Alignment: Optional[AlignmentResult] = None


_ZERO_ALIGNMENT = AlignmentResult()


@dataclass(slots=True)
class QueryResult:
    Query: QueryRecord
    Hits: List[Hit]
    PositionHits: Dict[int, List[bool]]
    HitEntries: Dict[int, Protein]


def filter_results(result: QueryResult, opts: SearchOptions) -> None:
    """In-place FilterResults (search.go:189-220)."""
    hits = result.Hits
    good = 0
    for h in hits:
        size = result.Query.SizeInKmer
        ratio = (h.Kmatch / size) if size else 0.0
        if ratio < opts.MinKRatio or h.Kmatch < opts.MinKMatch:
            break
        good += 1
    good = min(good, opts.MaxResults)
    removed = hits[good:]
    result.Hits = hits[:good]
    for h in removed:
        result.PositionHits.pop(h.Key, None)


def format_positions(positions, with_alignment: bool) -> str:
    """FormatPositionsToString (search.go:694-742), quirks included:
    a run terminated inside the query reports the 1-based position of the
    first NON-matching k-mer as its end; a run reaching the end reports
    len(positions).  Accepts a list of bools or a numpy bool array;
    vectorized (run edges via diff) because translated search formats one
    string per kept hit on the serving hot path."""
    import numpy as np

    arr = np.asarray(positions, dtype=bool)
    if arr.size == 0 or not arr.any():
        return ""
    edges = np.flatnonzero(np.diff(np.concatenate(
        (np.zeros(1, np.int8), arr.astype(np.int8), np.zeros(1, np.int8)))))
    starts = edges[0::2]          # 0-based first match of each run
    ends = edges[1::2]            # 0-based exclusive end of each run
    endpos = np.where(ends < arr.size, ends + 1, arr.size)
    if with_alignment:
        endpos = endpos + (KMER_SIZE - 1)
    return ",".join(
        f"{s}-{e}" for s, e in zip((starts + 1).tolist(), endpos.tolist())
    )


# ---------------------------------------------------------------------------
# TSV
# ---------------------------------------------------------------------------


def tsv_header(opts: SearchOptions, db_stats: KStats) -> str:
    if not opts.Align:
        cols = "QueryId\tSubjectId\t%KMatchIdentity\tQueryKLength\tKMatch\tGapOpen\tQStart\tQEnd\tSStart\tSEnd"
    else:
        cols = "QueryId\tSubjectId\t%Identity\tAlnLength\tMismatches\tGapOpen\tQStart\tQEnd\tSStart\tSEnd\tEvalue\tBitscore"
    if opts.ExtractPositions:
        cols += "\tQueryPositions"
    if opts.Annotations:
        for annotation in db_stats.Features:
            cols += "\t" + annotation
    return cols + "\n"


_PCT_CACHE: Dict[tuple, str] = {}


def _f32_pct(kmatch: int, size: int) -> str:
    """float32 percentage exactly like the Go writer (search.go:513).  The
    numpy-scalar round trip is ~5us; (kmatch, size) pairs repeat heavily in
    read search, so memoize (bounded)."""
    key = (kmatch, size)
    v = _PCT_CACHE.get(key)
    if v is None:
        import numpy as np

        if len(_PCT_CACHE) >= 1 << 16:
            _PCT_CACHE.clear()
        f = np.float32(kmatch) / np.float32(size) * np.float32(100.0)
        v = _PCT_CACHE[key] = f"{float(f):.2f}"
    return v


_EMPTY_PROTEIN = Protein()


def tsv_rows(qr: QueryResult, opts: SearchOptions, db_stats: KStats) -> List[str]:
    """One formatted line per hit.  Read search emits tens of rows per read
    at >10k reads/s, so the no-align branch is a single f-string per row
    with the per-query constants hoisted (same bytes as the reference
    writer, search.go:497-607)."""
    q = qr.Query
    qname = q.Name.split(" ", 1)[0]
    entries = qr.HitEntries
    feats = db_stats.Features if opts.Annotations else ()
    rows = []
    if not opts.Align:
        size = q.SizeInKmer
        sp, ep = q.Location.StartPosition, q.Location.EndPosition
        positions = opts.ExtractPositions
        pos_hits = qr.PositionHits
        for h in qr.Hits:
            prot = entries.get(h.Key, _EMPTY_PROTEIN)
            if positions:
                pos_string = format_positions(pos_hits.get(h.Key, ()), False)
                gap = pos_string.count(",")
            else:
                gap = "N/A"
            send = prot.Length if opts.Annotations else "N/A"
            row = (f"{qname}\t{prot.EntryId}\t{_f32_pct(h.Kmatch, size)}\t"
                   f"{size}\t{h.Kmatch}\t{gap}\t{sp}\t{ep}\t1\t{send}")
            # ("1": subject always starts at 1 in k-mer mode)
            if positions:
                row += "\t" + pos_string
            for annotation in feats:
                row += "\t" + prot.Features.get(annotation, "")
            rows.append(row + "\n")
        return rows
    for h in qr.Hits:
        prot = entries.get(h.Key, _EMPTY_PROTEIN)
        a = h.Alignment or _ZERO_ALIGNMENT
        out = [qname, prot.EntryId, f"{a.Identity:.2f}", str(a.Length),
               str(a.Mismatches), str(a.GapOpenings)]
        if opts.SequenceType != PROTEIN:
            out.append(str(q.Location.StartPosition))
            out.append(str(q.Location.EndPosition))
        else:
            out.append(str(a.QueryStart))
            out.append(str(a.QueryEnd))
        out.append(str(a.SubjectStart))
        out.append(str(a.SubjectEnd))
        out.append(f"{a.EValue:e}")
        out.append(f"{a.BitScore:.2f}")
        if opts.ExtractPositions:
            out.append(format_positions(qr.PositionHits.get(h.Key, []), True))
        for annotation in feats:
            out.append(prot.Features.get(annotation, ""))
        rows.append("\t".join(out) + "\n")
    return rows


# ---------------------------------------------------------------------------
# JSON
# ---------------------------------------------------------------------------


def json_result(qr: QueryResult, include_alignment: bool) -> str:
    """json.Marshal(QueryResult) equivalent (field order = Go struct order,
    map keys sorted lexicographically)."""
    obj = {
        "Query": {
            "Sequence": qr.Query.Sequence,
            "Name": qr.Query.Name,
            "SizeInKmer": qr.Query.SizeInKmer,
            "Type": qr.Query.Type,
            "Location": {
                "StartPosition": qr.Query.Location.StartPosition,
                "EndPosition": qr.Query.Location.EndPosition,
                "PlusStrand": qr.Query.Location.PlusStrand,
                "StartsAlternative": list(qr.Query.Location.StartsAlternative),
            },
            "Contig": qr.Query.Contig,
        },
        "SearchResults": {
            "Counter": {},
            "Hits": [
                {
                    "Key": h.Key,
                    "Kmatch": h.Kmatch,
                    "Alignment": (h.Alignment or _ZERO_ALIGNMENT).to_json_obj(),
                }
                for h in qr.Hits
            ],
            "PositionHits": {
                # bitmaps flow through the pipeline as numpy bool arrays;
                # JSON needs plain lists of bools
                str(k): (v.tolist() if hasattr(v, "tolist") else v)
                for k, v in sorted(qr.PositionHits.items(),
                                   key=lambda kv: str(kv[0]))
            },
        },
        "HitEntries": {
            str(k): qr.HitEntries[k].to_json_obj()
            for k in sorted(qr.HitEntries, key=lambda x: str(x))
        },
    }
    return json.dumps(obj, separators=(",", ":"), sort_keys=False)


def json_prologue(opts: SearchOptions, db_stats: KStats) -> str:
    parts = ['{"dbProteinFeatures":[']
    if opts.Annotations:
        parts.append(",".join(f'"{a}"' for a in db_stats.Features))
    parts.append('],"results":[')
    return "".join(parts)


JSON_EPILOGUE = "]}"
