"""Judge of TSV bodies: protein search, and translated search of reads or
contigs.  Each judged record's rows are grouped by the query's start and
end (a translated record has one group an ORF, a protein one) and must
equal the reference's rows exactly, in order within a group."""

from __future__ import annotations

from typing import Dict, List

from ..reference import rows as ref

# an exact comparison: the limit of the number compared
LIMIT = 0

TRANSLATED = ("/api/search/fastq", "/api/search/nucleotide")

# a kaamer server's search defaults (api/server.go), and the form fields
# that change them
DEFAULTS = {"max_results": 10, "min_kmatch": 10, "min_kratio": 0.05}
FIELDS = {"max-results": ("max_results", int),
          "minkmatch": ("min_kmatch", int),
          "minkratio": ("min_kratio", float)}


def options(fields: Dict) -> Dict:
    opts = dict(DEFAULTS)
    for field, (key, kind) in FIELDS.items():
        if field in fields:
            opts[key] = kind(fields[field])
    return opts


def expected(db, route: str, options: Dict, name: str, seq: str,
             precision: str = "float32") -> List[str]:
    if route in TRANSLATED:
        return ref.translated_rows(db.postings, db.ids, name, seq, options,
                                   precision)
    return ref.protein_rows(db.postings, db.ids, name, seq, options,
                            precision)


def grouped(rows: List[str]) -> Dict[tuple, List[str]]:
    out: Dict[tuple, List[str]] = {}
    for r in rows:
        f = r.split("\t")
        out.setdefault((f[6], f[7]), []).append(r)
    return out


def judge(db, route: str, options: Dict, requests: List[Dict],
          control: bool = False, log=None) -> Dict[str, Dict]:
    """The numbers compared, each with its limit: `queries_wrong`, the
    judged records whose rows differ from the reference's or never came.
    `requests`: the window's requests as the clients recorded them
    ("sample": the judged records' name, seq and received rows, None where
    the answer never came).  control=True judges the reference computed
    in bfloat16 in the program's place."""
    wrong = 0
    compared = 0
    for req in requests:
        for s in req["sample"]:
            if s["rows"] is None and not control:
                compared += 1
                wrong += 1
                continue
            exp = expected(db, route, options, s["name"], s["seq"])
            got = (expected(db, route, options, s["name"], s["seq"],
                            "bfloat16") if control else s["rows"])
            compared += 1
            if grouped(got) != grouped(exp):
                wrong += 1
                if log is not None and wrong <= 3:
                    log(f"judge: {s['name']} differs: received "
                        f"{got[:4]} expected {exp[:4]}")
    if log is not None:
        log(f"judge: compared {compared} records of {len(requests)} "
            f"requests")
    return {"queries_wrong": {"value": wrong, "limit": LIMIT}}
