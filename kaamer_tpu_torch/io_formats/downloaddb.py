"""Data acquisition: UniProt / RefSeq / NCBI genome downloads and KEGG /
BioCyc pathway annotation (reference pkg/downloaddb/*), the torch port's
copy of kaamer_tpu/io_formats/downloaddb.py.  It does no device work; it
reads and rewrites the port's artifact (index/artifact.py).

Network-facing functionality; in offline environments these raise clear
errors (nothing catches them but the per-id pathway fetches, which count
no pathway for an id they cannot fetch, as the JAX module does).  Every fetch
goes through ftplib.FTP, urllib.request.urlopen and the module's host
and URL constants.  URL layouts, valid taxa sets, file naming, and
parsing behavior follow the reference:

- DownloadUniprot (downloadUniprot.go:46-87): sprot+trembl per-taxon FTP
  flat files concatenated into one .dat.gz, plus the LICENSE file.
- DownloadRefseq (downloadNCBI.go:54-81): all *.nonredundant_protein.*.gpff.gz
  of a release taxon concatenated.
- DownloadGenbankGenome + ParseGenbank (downloadNCBI.go:83-222): eutils
  esearch/efetch, then CDS extraction into a kaamer TSV
  (EntryID/GeneName/ProteinName/Sequence).
- DownloadKEGG / DownloadBiocyc (downloadKegg.go:41-196,
  downloadBiocyc.go:41-200): stream the protein store, query the REST API per
  KEGG_ID / BioCyc_ID feature, write a KEGG_Pathways / BioCyc_Pathways
  feature back in place.  Like the reference, db_stats.Features is NOT
  extended (quirk preserved; annotations added this way only appear in
  JSON output).
"""

from __future__ import annotations

import ftplib
import json
import os
import re
import sys
import urllib.request
import xml.etree.ElementTree as ET
from typing import Callable, List

from ..index import artifact

UNIPROT_FTP_HOST = "ftp.uniprot.org"
UNIPROT_TAXONOMIC_PATH = (
    "/pub/databases/uniprot/current_release/knowledgebase/taxonomic_divisions/"
)
UNIPROT_VALID_TAXA = {
    "archaea", "bacteria", "fungi", "human", "invertebrates",
    "mammals", "plants", "rodents", "vertebrates", "viruses",
}

NCBI_REFSEQ_FTP_HOST = "ftp.ncbi.nlm.nih.gov"
NCBI_REFSEQ_PATH = "/refseq/release/"
NCBI_EUTILS = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/"
NCBI_REFSEQ_VALID = {
    "archaea", "bacteria", "fungi", "invertebrate", "mitochondrion", "plant",
    "plasmid", "plastid", "protozoa", "viral", "vertebrate_mammalian",
    "vertebrate_other",
}

KEGG_API = "http://rest.kegg.jp"
BIOCYC_API = "https://websvc.biocyc.org"


def _ftp_retrieve(host: str, path: str, out, progress: bool = True):
    ftp = ftplib.FTP(host, timeout=30)
    ftp.login()
    n = [0]

    def write(chunk: bytes):
        out.write(chunk)
        n[0] += len(chunk)
        if progress and n[0] % (1 << 24) < 8192:
            print(f"  .. {n[0] / 1e6:.0f} MB", file=sys.stderr)

    ftp.retrbinary(f"RETR {path}", write)
    ftp.quit()


def _ftp_list(host: str, path: str) -> List[str]:
    ftp = ftplib.FTP(host, timeout=30)
    ftp.login()
    names = ftp.nlst(path)
    ftp.quit()
    return [os.path.basename(n) for n in names]


def download_uniprot(output_file: str, taxon: str) -> None:
    if taxon not in UNIPROT_VALID_TAXA:
        raise ValueError("Invalid taxon !")
    if not output_file:
        output_file = f"uniprotkb-{taxon}.dat.gz"
    out_dir = os.path.dirname(output_file) or "."
    with open(os.path.join(out_dir, "LICENSE"), "wb") as lic:
        print("# Downloading uniprotkb - LICENSE..")
        _ftp_retrieve(UNIPROT_FTP_HOST, UNIPROT_TAXONOMIC_PATH + "LICENSE", lic)
    with open(output_file, "wb") as dst:
        print(f"# Downloading uniprotkb - swissprot ({taxon})..")
        _ftp_retrieve(
            UNIPROT_FTP_HOST,
            UNIPROT_TAXONOMIC_PATH + f"uniprot_sprot_{taxon}.dat.gz", dst,
        )
        print(f"# Downloading uniprotkb - trembl ({taxon})..")
        _ftp_retrieve(
            UNIPROT_FTP_HOST,
            UNIPROT_TAXONOMIC_PATH + f"uniprot_trembl_{taxon}.dat.gz", dst,
        )
    print(f"See LICENSE : {os.path.join(out_dir, 'LICENSE')}")


def download_refseq(output_file: str, taxon: str) -> None:
    if taxon not in NCBI_REFSEQ_VALID:
        raise ValueError("Invalid taxon !")
    if not output_file:
        output_file = f"refseq-{taxon}.gpff.gz"
    path = NCBI_REFSEQ_PATH + taxon
    names = _ftp_list(NCBI_REFSEQ_FTP_HOST, path)
    with open(output_file, "wb") as dst:
        for name in names:
            if ".nonredundant_protein." in name and name.endswith(".gpff.gz"):
                print(f"# Downloading {name} into {output_file}..")
                _ftp_retrieve(NCBI_REFSEQ_FTP_HOST, f"{path}/{name}", dst)


def download_genbank_genome(genome_id: str) -> str:
    """eutils fetch + CDS extraction to TSV; returns the TSV path."""
    with urllib.request.urlopen(
        NCBI_EUTILS + "esearch.fcgi?db=nucleotide&term=" + genome_id
    ) as resp:
        root = ET.fromstring(resp.read())
    ids = [e.text for e in root.findall(".//IdList/Id")]
    if not ids:
        raise ValueError(f"no nucleotide record found for {genome_id}")
    gbk_file = genome_id + ".gbk"
    with urllib.request.urlopen(
        NCBI_EUTILS + "efetch.fcgi?db=nucleotide&rettype=gb&id=" + ids[0]
    ) as resp, open(gbk_file, "wb") as dst:
        dst.write(resp.read())
    return parse_genbank_cds(gbk_file)


_ATTR_RE = re.compile(r'\s+/.*="(.*)')
_GENE_RE = re.compile(r'\s+/gene="(.*)"')
_PROTID_RE = re.compile(r'\s+/protein_id="(.*)"')
_PRODUCT_RE = re.compile(r'\s+/product="(.*)')
_TRANSL_RE = re.compile(r'\s+/translation="(.*)')


def parse_genbank_cds(gbk_file: str) -> str:
    """ParseGenbank equivalent (downloadNCBI.go:118-222): extract CDS records
    from a GenBank nucleotide file into a kaamer TSV."""
    out_path = gbk_file.replace(".gbk", ".tsv")
    cds = {"EntryId": "", "GeneName": "", "ProteinName": "", "Sequence": ""}
    inside_cds = inside_name = inside_transl = False

    def flush(out):
        if cds["EntryId"]:
            name = cds["ProteinName"].rstrip('"')
            seq = cds["Sequence"].rstrip('"')
            out.write(f"{cds['EntryId']}\t{cds['GeneName']}\t{name}\t{seq}\n")

    with open(gbk_file) as f, open(out_path, "w") as out:
        out.write("EntryID\tGeneName\tProteinName\tSequence\n")
        for line in f:
            line = line.rstrip("\n")
            if len(line) < 21:
                continue
            if line[0:21] == "     CDS             ":
                flush(out)
                cds = {"EntryId": "", "GeneName": "", "ProteinName": "", "Sequence": ""}
                inside_cds = True
                inside_name = inside_transl = False
            elif line[0:21] != "                     ":
                inside_cds = False
            if not inside_cds:
                continue
            if _ATTR_RE.match(line):
                inside_name = inside_transl = False
            if inside_transl:
                cds["Sequence"] += line.strip(" ")
            if inside_name:
                cds["ProteinName"] += line.strip(" ")
            if "/gene=" in line:
                m = _GENE_RE.match(line)
                if m:
                    cds["GeneName"] = m.group(1)
            if "/product=" in line:
                m = _PRODUCT_RE.match(line)
                if m:
                    cds["ProteinName"] = m.group(1)
                    inside_name = True
            if "/translation=" in line:
                m = _TRANSL_RE.match(line)
                if m:
                    cds["Sequence"] = m.group(1)
                    inside_transl = True
            if "/protein_id=" in line:
                m = _PROTID_RE.match(line)
                if m:
                    cds["EntryId"] = m.group(1)
        flush(out)
    return out_path


# ---------------------------------------------------------------------------
# In-place pathway annotation (KEGG / BioCyc)
# ---------------------------------------------------------------------------


def _annotate_db(db_path: str, id_feature: str, out_feature: str,
                 fetch: Callable[[str], List[str]]) -> None:
    """Stream the protein store, query `fetch` per cross-reference id, and
    write the pathway feature back (downloadKegg.go:59-153 semantics)."""
    db = artifact.load_db(db_path, mmap=False)
    features: List[bytes] = []
    for row in range(db.num_proteins):
        raw = db._features.get(row)
        feats = json.loads(raw) if raw else {}
        xrefs = feats.get(id_feature, "")
        if xrefs:
            print(f"{id_feature}s for {db._entry_ids.get_str(row)}.. ", end="")
            feats[out_feature] = ""
            for xref in xrefs.split(";"):
                pathways = fetch(xref)
                print(len(pathways))
                if pathways:
                    feats[out_feature] = ";".join(pathways)
        features.append(
            json.dumps(feats, separators=(",", ":")).encode() if feats else b""
        )

    # rewrite only the features blob
    artifact._write_blob(os.path.join(db_path, "features"), features)


_WS_RE = re.compile(r"\s+")


def get_kegg_pathways(kegg_id: str) -> List[str]:
    try:
        with urllib.request.urlopen(f"{KEGG_API}/get/{kegg_id}") as resp:
            body = resp.read().decode("utf-8", errors="replace")
    except OSError as e:
        print(str(e))
        return []
    pathways = []
    inside = False
    for l in body.split("\n"):
        if len(l) < 7:
            continue
        if l[0:7] == "PATHWAY":
            inside = True
            parts = _WS_RE.split(l, 2)
            pathways.append(f"{parts[2]} [{parts[1]}]")
        elif inside:
            if l[0:7] != "       ":
                inside = False
            else:
                parts = _WS_RE.split(l, 2)
                pathways.append(f"{parts[2]} [{parts[1]}]")
    return pathways


def get_biocyc_pathways(biocyc_id: str) -> List[str]:
    try:
        with urllib.request.urlopen(
            f"{BIOCYC_API}/apixml?fn=pathways-of-gene&id={biocyc_id}"
        ) as resp:
            root = ET.fromstring(resp.read())
    except (OSError, ET.ParseError):
        return []
    pathways = []
    for p in root.findall(".//Pathway"):
        name = p.findtext("common-name", default="")
        pid = p.get("ID", "")
        pathways.append(f"{name} [{pid}]")
    return pathways


def download_kegg(db_path: str, assume_yes: bool = False) -> None:
    print("## Notice ##")
    print("KEGG API is provided for academic use by academic users belonging "
          "to academic institutions.")
    print("See https://www.kegg.jp/kegg/rest/")
    if not assume_yes:
        answer = input("Do you accept KEGG terms and conditions Y/n : ")
        if answer.strip().lower() != "y":
            print("I am sorry you couldn't accept that license")
            return
    _annotate_db(db_path, "KEGG_ID", "KEGG_Pathways", get_kegg_pathways)


def download_biocyc(db_path: str, assume_yes: bool = False) -> None:
    print("## Notice ##")
    print("See https://bioinformatics.ai.sri.com/ptools/licensing/all-reg.shtml")
    if not assume_yes:
        answer = input("Do you accept BioCyc terms and conditions Y/n : ")
        if answer.strip().lower() != "y":
            print("I am sorry you couldn't accept that license")
            return
    _annotate_db(db_path, "BioCyc_ID", "BioCyc_Pathways", get_biocyc_pathways)
