"""Judge of -aln TSV bodies of protein search (`align=true`).

Per judged record, the reference's k-mer hits are kept first
(reference/rows.py: ranking, FilterResults, MaxResults); each hit is then
aligned with the plain reference (reference/align.py), the hits re-sort
by bit score, highest first, keeping their k-mer order among equal scores
(search.go:483-494), and each becomes the -aln row of docs/client.md:

    QueryId SubjectId %Identity AlnLength Mismatches GapOpen QStart QEnd
    SStart SEnd Evalue Bitscore

(%Identity with two decimals, Evalue as %e, Bitscore as %.2f).  A judged
record's rows must equal the reference's exactly and in order."""

from __future__ import annotations

from typing import Dict, List

from ..reference import align as aln
from ..reference import rows as ref
from ..reference.kmers import K, seq_codes
from .tsv import options as kmer_options

# an exact comparison: the limit of the number compared
LIMIT = 0

# the alignment's form fields: the reference aligns with a kaamer
# server's defaults only
ALIGN_FIELDS = ("sub-matrix", "gap-open", "gap-extend")


def options(fields: Dict) -> Dict:
    for field in ALIGN_FIELDS:
        if fields.get(field, ""):
            raise ValueError(f"the -aln reference aligns with BLOSUM62 and "
                             f"gaps 11/1 only, not {field}={fields[field]}")
    return kmer_options(fields)


def kept_hits(db, seq: str, opts: Dict, precision: str = "float32"):
    """The database rows of a protein query's kept k-mer hits, in rank
    order."""
    size = len(seq) - K + 1
    if size < K:  # kaamer skips a query this short
        return []
    rows, counts, _ = db.postings.ranked_hits(seq_codes(seq, size))
    rows, counts = ref._counted(rows, counts, precision)
    return rows[:ref._kept(counts, size, opts)].tolist()


def _row(qname: str, sid: str, a: aln.Alignment) -> str:
    return (f"{qname}\t{sid}\t{a.identity:.2f}\t{a.length}\t{a.mismatches}"
            f"\t{a.gap_openings}\t{a.qstart}\t{a.qend}\t{a.sstart}\t{a.send}"
            f"\t{a.evalue:e}\t{a.bitscore:.2f}\n")


def expected_rows(db, records, opts: Dict, precision: str = "float32"):
    """The -aln rows of each (name, seq) record, and the length of the
    longest subject aligned; all records' pairs are aligned together."""
    hits = [kept_hits(db, seq, opts, precision) for _, seq in records]
    pairs = [(seq, db.protein(r).tobytes().decode())
             for (_, seq), rows in zip(records, hits) for r in rows]
    found = aln.align_pairs(pairs, int(db.residues.shape[0]), precision)
    out, k = [], 0
    for (name, _), rows in zip(records, hits):
        got = list(zip(rows, found[k:k + len(rows)]))
        k += len(rows)
        got.sort(key=lambda h: -h[1].bitscore)  # stable: k-mer order kept
        qname = name.split(" ", 1)[0]
        out.append([_row(qname, db.ids[r], a) for r, a in got])
    return out, max((len(r) for _, r in pairs), default=0)


def judge(db, route: str, options: Dict, requests: List[Dict],
          control: bool = False, log=None) -> Dict[str, Dict]:
    """The numbers compared, each with its limit: `queries_wrong`, the
    judged records whose rows differ from the reference's or never came.
    control=True judges the reference computed in bfloat16 (the k-match
    counts, identity, bit score and E-value) in the program's place."""
    if route != "/api/search/protein":
        raise ValueError(f"the -aln judge reads protein search, not {route}")
    samples = [s for req in requests for s in req["sample"]]
    records = [(s["name"], s["seq"]) for s in samples]
    exp, longest_subject = expected_rows(db, records, options)
    got = (expected_rows(db, records, options, "bfloat16")[0] if control
           else [s["rows"] for s in samples])
    wrong = 0
    for s, e, g in zip(samples, exp, got):
        if g != e:
            wrong += 1
            if log is not None and wrong <= 3:
                log(f"judge: {s['name']} differs: received "
                    f"{(g or [])[:3]} expected {e[:3]}")
    if log is not None:
        longest = max((len(seq) for _, seq in records), default=0)
        log(f"judge: compared {len(samples)} records of {len(requests)} "
            f"requests, {sum(map(len, exp))} alignments; longest judged "
            f"query {longest} residues, longest subject {longest_subject}")
    return {"queries_wrong": {"value": wrong, "limit": LIMIT}}
