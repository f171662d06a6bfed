"""Input-format readers: database build parsers and query readers.

Database parsers yield (protein_id, Protein) pairs and mirror the reference's
parsing semantics:

- FASTA  (reference pkg/makedb/inputFASTA.go): header '>' lines; EntryId is
  the first header token; ProteinName the rest; entries whose ProteinName
  contains ", partial" are skipped (inputFASTA.go:219-221), as are sequences
  shorter than the k-mer size (226-228).  Protein ids are 1-based in file
  order.  (The reference's accumulator flushes entry k under id k+1 and
  collides the final two ids, inputFASTA.go:96-124 -- a data-loss bug we do
  not reproduce.)
- TSV    (inputTSV.go): first row is the header; EntryID and Sequence columns
  required (case-insensitive, inputTSV.go:98-113); every other column becomes
  a feature; rows with short/empty sequence or id are dropped BEFORE id
  assignment; ids are 0-based (inputTSV.go:63,141-142 -- quirk preserved).
- EMBL   (inputEMBL.go): UniProt flat text; ID/GN/DE/OX/OS/OC/DR/SQ line
  types; 'Flags: Fragment;' entries skipped (224-227); ids 1-based per '//'
  terminator.
- GenBank (inputGBK.go): LOCUS/DEFINITION/VERSION/ORGANISM/ORIGIN state
  machine; ", partial" entries skipped; ids 1-based per '//'.

All readers sniff gzip via magic bytes (the reference sniffs content-type,
inputFASTA.go:74-79).

Query readers replicate pkg/search/search.go:222-412: FASTA queries report
SizeInKmer = len - K + 1 (minus one when the sequence ends in '*'); FASTQ
sequence lines must match ^[ATGCNatgcn]+$.
"""

from __future__ import annotations

import gzip
import io
import re
from typing import Iterator, List, Tuple

from ..records import Protein

KMER_SIZE = 7
MAX_LENGTH = 2**63  # stands in for the CLI's MaxInt default length


def open_maybe_gzip(path: str):
    """Open a text file, transparently decoding gzip (sniffed by magic)."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="utf-8", errors="replace")
    return io.TextIOWrapper(f, encoding="utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Database build parsers
# ---------------------------------------------------------------------------

FASTA_DEF_FTS = ["ProteinName"]  # inputFASTA.go:41
EMBL_DEF_FTS = [
    "ProteinName", "GeneName", "EC", "GO", "KEGG_ID",
    "BioCyc_ID", "HAMAP", "Organism", "TaxId", "FullTaxonomy",
]  # inputEMBL.go:43
GBK_DEF_FTS = ["ProteinName", "Organism", "FullTaxonomy"]  # inputGBK.go:42


def parse_fasta(path: str, offset: int = 0, length: int = MAX_LENGTH) -> Iterator[Tuple[int, Protein]]:
    pid = 0
    last = offset + length
    name = None
    seq_parts: List[str] = []

    def finish(pid: int, name: str, seq_parts: List[str]):
        header = name.split(" ")
        entry_id = header[0]
        protein_name = " ".join(header[1:])
        if ", partial" in protein_name:
            return None
        seq = "".join(seq_parts).upper()
        if len(seq) < KMER_SIZE:
            return None
        return (
            pid,
            Protein(EntryId=entry_id, Sequence=seq, Length=len(seq),
                    Features={"ProteinName": protein_name}),
        )

    with open_maybe_gzip(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] == ">":
                if name is not None and offset <= pid:
                    out = finish(pid, name, seq_parts)
                    if out:
                        yield out
                pid += 1
                if pid >= last:
                    name = None
                    break
                name = line[1:]
                seq_parts = []
            else:
                if name is not None:
                    seq_parts.append(line.strip())
        if name is not None and offset <= pid < last:
            out = finish(pid, name, seq_parts)
            if out:
                yield out


def parse_tsv(path: str, offset: int = 0, length: int = MAX_LENGTH) -> Iterator[Tuple[int, Protein]]:
    last = offset + length
    with open_maybe_gzip(path) as f:
        header = None
        pid = 0  # TSV ids are 0-based (inputTSV.go:63) -- reference quirk
        for line in f:
            line = line.rstrip("\n")
            if header is None:
                header = line.split("\t")
                lower = [h.lower() for h in header]
                if "entryid" not in lower:
                    raise ValueError("TSV file doesn't contain 'EntryID' header")
                if "sequence" not in lower:
                    raise ValueError("TSV file doesn't contain 'Sequence' header")
                continue
            cols = line.split("\t")
            prot = Protein(Features={})
            for i, val in enumerate(cols):
                if i >= len(header):
                    break
                h = header[i].lower()
                if h == "entryid":
                    prot.EntryId = val
                elif h == "sequence":
                    prot.Sequence = val
                    prot.Length = len(val)
                else:
                    prot.Features[header[i]] = val
            if prot.Length < KMER_SIZE or not prot.Sequence or not prot.EntryId:
                continue
            if pid >= last:
                break
            if pid >= offset:
                yield pid, prot
            pid += 1


_EMBL_BRACE_RE = re.compile(r" \{.*\};")


def _parse_embl_entry(pid: int, lines: List[str]):
    prot = Protein(Features={})
    features = prot.Features
    for l in lines:
        if len(l) < 2:
            continue
        tag = l[0:2]
        if tag == "ID":
            prot.EntryId = l[5:].split()[0]
        elif tag == "GN":
            if features.get("GeneName", "") == "" and "Name=" in l:
                gene = l[5:].split()[0][5:]
                features["GeneName"] = gene.rstrip(";")
        elif tag == "DE":
            body = l[5:]
            if "RecName" in body:
                features["ProteinName"] = _EMBL_BRACE_RE.sub("", l[19:]).rstrip(";")
            elif "SubName" in body:
                sub = _EMBL_BRACE_RE.sub("", l[19:]).rstrip(";")
                if features.get("ProteinName", ""):
                    features["ProteinName"] += ";;" + sub
                else:
                    features["ProteinName"] = sub
            elif "EC=" in body:
                features["EC"] = _EMBL_BRACE_RE.sub("", l[17:]).rstrip(";")
            elif "Flags: Fragment;" in body:
                return None  # skip protein fragments (inputEMBL.go:224-227)
        elif tag == "OX":
            # the reference slices [12:] past "NCBI_TaxID=" (11 chars) and
            # drops the first digit (inputEMBL.go:229) -- fixed here
            token = l[5:].split()[0]
            features["TaxId"] = token.split("=", 1)[-1].rstrip(";")
        elif tag == "OS":
            if "Organism" in features:
                features["Organism"] += " " + l[5:].rstrip(".")
            else:
                features["Organism"] = l[5:].rstrip(".")
        elif tag == "OC":
            if features.get("FullTaxonomy", ""):
                features["FullTaxonomy"] += " "
            features["FullTaxonomy"] = features.get("FullTaxonomy", "") + l[5:]
        elif tag == "DR":
            fields = l[5:].split()
            mapping = {"KEGG;": "KEGG_ID", "GO;": "GO",
                       "BioCyc;": "BioCyc_ID", "HAMAP;": "HAMAP"}
            key = mapping.get(fields[0])
            if key and len(fields) > 1:
                val = fields[1].rstrip(";")
                if features.get(key, ""):
                    features[key] += ";" + val
                else:
                    features[key] = val
        elif tag == "SQ":
            fields = l[5:].split()
            if len(fields) > 1:
                try:
                    prot.Length = int(fields[1])
                except ValueError:
                    pass
        elif tag == "  ":
            prot.Sequence += l[5:].replace(" ", "")
    if prot.Length < KMER_SIZE:
        return None
    return pid, prot


def parse_embl(path: str, offset: int = 0, length: int = MAX_LENGTH) -> Iterator[Tuple[int, Protein]]:
    last = offset + length
    pid = 0
    lines: List[str] = []
    with open_maybe_gzip(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line == "//":
                pid += 1
                if pid >= offset and lines:
                    out = _parse_embl_entry(pid, lines)
                    if out:
                        yield out
                lines = []
                if pid + 1 >= last and last < MAX_LENGTH:
                    break
            else:
                if pid + 1 >= offset:
                    lines.append(line)


_GBK_BRACKET_RE = re.compile(r" \[.*\]\.")

_GBK_SECTION = {
    "LOCUS": 0, "DEFINITION": 1, "ACCESSION": 0, "VERSION": 2, "KEYWORDS": 0,
    "SOURCE": 0, "ORGANISM": 3, "COMMENT": 0, "FEATURES": 4, "ORIGIN": 5,
    "//": 6, "REFERENCE": 0, "DBLINK": 0, "DBSOURCE": 0,
}


def _parse_gbk_entry(pid: int, lines: List[str]):
    prot = Protein(Features={})
    features = prot.Features
    state = 0
    for l in lines:
        if len(l) < 2:
            continue
        first = l.strip(" ").split(" ")[0]
        if first in _GBK_SECTION:
            state = _GBK_SECTION[first]
        if state == 1:
            if features.get("ProteinName", ""):
                features["ProteinName"] += " "
            features["ProteinName"] = features.get("ProteinName", "") + l[12:]
        elif state == 2:
            fields = l[12:].split()
            if fields:
                prot.EntryId = fields[0]
        elif state == 3:
            if features.get("Organism", "") == "":
                features["Organism"] = l[12:]
            else:
                if features.get("FullTaxonomy", ""):
                    features["FullTaxonomy"] += " "
                features["FullTaxonomy"] = features.get("FullTaxonomy", "") + l[12:]
        elif state == 5:
            if len(l) > 10 and l[10:]:
                prot.Sequence += l[10:].replace(" ", "").upper()
    if ", partial" in features.get("ProteinName", ""):
        return None
    prot.Length = len(prot.Sequence)
    if prot.Length < KMER_SIZE:
        return None
    features["ProteinName"] = _GBK_BRACKET_RE.sub("", features.get("ProteinName", ""))
    return pid, prot


def parse_gbk(path: str, offset: int = 0, length: int = MAX_LENGTH) -> Iterator[Tuple[int, Protein]]:
    last = offset + length
    pid = 0
    lines: List[str] = []
    with open_maybe_gzip(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line == "//":
                pid += 1
                if pid >= offset and lines:
                    out = _parse_gbk_entry(pid, lines)
                    if out:
                        yield out
                lines = []
                if pid + 1 >= last and last < MAX_LENGTH:
                    break
            else:
                if pid + 1 >= offset:
                    lines.append(line)


PARSERS = {
    "fasta": (parse_fasta, FASTA_DEF_FTS),
    "tsv": (parse_tsv, None),  # TSV features come from the header row
    "embl": (parse_embl, EMBL_DEF_FTS),
    "gbk": (parse_gbk, GBK_DEF_FTS),
    "genbank": (parse_gbk, GBK_DEF_FTS),
}


# ---------------------------------------------------------------------------
# Query readers (search-time)
# ---------------------------------------------------------------------------


class QueryLocation:
    """Slotted: one per query/ORF on the serving hot path."""

    __slots__ = ("StartPosition", "EndPosition", "PlusStrand", "StartsAlternative")

    def __init__(self, StartPosition=1, EndPosition=0, PlusStrand=True,
                 StartsAlternative=None):
        self.StartPosition = StartPosition
        self.EndPosition = EndPosition
        self.PlusStrand = PlusStrand
        self.StartsAlternative = [] if StartsAlternative is None else StartsAlternative


class QueryRecord:
    __slots__ = ("Sequence", "Name", "SizeInKmer", "Type", "Location", "Contig")

    def __init__(self, Sequence="", Name="", SizeInKmer=0, Type="",
                 Location=None, Contig=""):
        self.Sequence = Sequence
        self.Name = Name
        self.SizeInKmer = SizeInKmer
        self.Type = Type
        self.Location = Location if Location is not None else QueryLocation()
        self.Contig = Contig


def read_fasta_queries(path: str, is_protein: bool) -> Iterator[QueryRecord]:
    """FASTA query reader (search.go:222-322).  Sequences uppercased; the
    name is the full header line; SizeInKmer excludes a trailing '*'."""
    name = ""
    seq_parts: List[str] = []

    def finish() -> QueryRecord:
        seq = "".join(seq_parts).upper()
        n = len(seq) - KMER_SIZE + 1
        if seq.endswith("*"):
            n -= 1
        return QueryRecord(
            Sequence=seq,
            Name=name,
            SizeInKmer=n,
            Location=QueryLocation(StartPosition=1, EndPosition=len(seq)),
            Contig="" if is_protein else name,
        )

    with open_maybe_gzip(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if len(line) < 1:
                continue
            if line[0] == ">":
                if seq_parts:
                    yield finish()
                name = line[1:]
                seq_parts = []
            else:
                seq_parts.append(line.strip())
        if seq_parts:
            yield finish()


_FASTQ_SEQ_RE = re.compile(r"^[ATGCNatgcn]+$")


def read_fastq_queries(path: str) -> Iterator[QueryRecord]:
    """FASTQ reader (search.go:324-412): '@' starts a record; only lines
    matching ^[ATGCNatgcn]+$ count as sequence (last such line wins)."""
    name = ""
    seq = ""
    started = False
    with open_maybe_gzip(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if len(line) < 1:
                continue
            if line[0] == "@":
                if started and seq:
                    yield QueryRecord(
                        Sequence=seq, Name=name,
                        SizeInKmer=len(seq) - KMER_SIZE + 1,
                        Location=QueryLocation(StartPosition=1, EndPosition=len(seq)),
                    )
                name = line[1:]
                seq = ""
                started = True
            elif _FASTQ_SEQ_RE.match(line):
                seq = line
        if started and seq:
            yield QueryRecord(
                Sequence=seq, Name=name,
                SizeInKmer=len(seq) - KMER_SIZE + 1,
                Location=QueryLocation(StartPosition=1, EndPosition=len(seq)),
            )
