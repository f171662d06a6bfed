"""The port's downloader (kaamer_tpu_torch/io_formats/downloaddb.py) and
`kaamer-db -download` against the JAX package's, under the same fakes:
ftplib.FTP is replaced by an in-memory server, and the eutils, KEGG and
BioCyc URL constants of both modules point at an http.server on
127.0.0.1 that serves bodies written here.  Nothing reaches past
127.0.0.1.

Compared, byte for byte: the files each download writes, the GenBank
CDS table, the annotated database's features blob and its JSON search
output (the port's CPU engine against the JAX engine), every stdout
text, error and return code."""

import ftplib
import http.server
import io
import os
import shutil
import sys
import threading
import urllib.request

import numpy as np
import pytest

from kaamer_tpu import cli as jax_cli
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.io_formats import downloaddb as jax_dl
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.search.options import SearchOptions as JaxOptions
from kaamer_tpu.search.pipeline import run_search as jax_run_search
from kaamer_tpu_torch import cli
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.io_formats import downloaddb
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.search.options import PROTEIN, SearchOptions
from kaamer_tpu_torch.search.pipeline import run_search

MODULES = {"jax": jax_dl, "torch": downloaddb}
MAINS = {"jax": jax_cli.kaamer_db_main, "torch": cli.kaamer_db_main}
AA = "ACDEFGHIKLMNPQRSTVWY"

# ---------------------------------------------------------------------------
# the fakes
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(4)
UNIPROT = "/pub/databases/uniprot/current_release/knowledgebase/" \
          "taxonomic_divisions/"
REFSEQ_DIR = "/refseq/release/bacteria"
REFSEQ_NAMES = [
    "bacteria.nonredundant_protein.1.protein.gpff.gz",
    "bacteria.nonredundant_protein.1.protein.faa.gz",
    "bacteria.1.genomic.gbff.gz",
    "bacteria.wp_protein.1.protein.gpff.gz",
    "bacteria.nonredundant_protein.2.protein.gpff.gz",
]
# (host, path) -> bytes; sizes that take several 4 KiB callbacks
FTP_FILES = {
    ("ftp.uniprot.org", UNIPROT + "LICENSE"): b"Creative Commons BY 4.0\n",
    ("ftp.uniprot.org", UNIPROT + "uniprot_sprot_bacteria.dat.gz"):
        _rng.bytes(10_000),
    ("ftp.uniprot.org", UNIPROT + "uniprot_trembl_bacteria.dat.gz"):
        _rng.bytes(9_001),
    **{("ftp.ncbi.nlm.nih.gov", f"{REFSEQ_DIR}/{n}"): _rng.bytes(5_000 + i)
       for i, n in enumerate(REFSEQ_NAMES)},
}
FTP_DIRS = {("ftp.ncbi.nlm.nih.gov", REFSEQ_DIR):
            [f"{REFSEQ_DIR}/{n}" for n in REFSEQ_NAMES]}


class FakeFTP:
    """ftplib.FTP's calls the downloader makes, over FTP_FILES and
    FTP_DIRS; every call is logged in LOG."""

    LOG = []

    def __init__(self, host, timeout=None):
        self.host = host
        self.LOG.append(("connect", host, timeout))

    def login(self):
        self.LOG.append(("login",))

    def retrbinary(self, cmd, callback):
        self.LOG.append(("retrbinary", cmd))
        path = cmd.split(" ", 1)[1]
        if (self.host, path) not in FTP_FILES:
            raise ftplib.error_perm(f"550 {path}: No such file")
        data = FTP_FILES[(self.host, path)]
        for i in range(0, len(data), 4096):
            callback(data[i:i + 4096])

    def nlst(self, path):
        self.LOG.append(("nlst", path))
        return list(FTP_DIRS[(self.host, path)])

    def quit(self):
        self.LOG.append(("quit",))


GENBANK = """\
LOCUS       NC_TEST                 1200 bp    DNA     linear   CON 01-JAN-2020
DEFINITION  Testus testus chromosome, complete genome.
ACCESSION   NC_TEST
FEATURES             Location/Qualifiers
     source          1..1200
                     /organism="Testus testus"
     gene            10..600
                     /gene="abcD"
     CDS             10..600
                     /gene="abcD"
                     /codon_start=1
                     /product="ATP-binding cassette domain-containing protein
                     with a long name"
                     /protein_id="WP_000001.1"
                     /translation="MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQD
                     NLSGAEKAVQVKVKALPDAQFEVVHSLAKWKRQTLGQHDFSAGEGLYTHMKALRPDE
                     IGGGIGQSRLTMLLLQLPHIGQVQAGVWPAACRESVPALLE"
     CDS             complement(700..900)
                     /gene="efgH"
                     /product="hypothetical protein"
                     /protein_id="WP_000002.1"
                     /translation="MSTNPKPQRKTKRNTNRRPQDVKFPGG"
     CDS             950..1100
                     /product="a CDS with no protein id"
                     /translation="MAAAKKK"
     misc_feature    1110..1150
                     /note="not a CDS"
ORIGIN
        1 atgaaaacag cgtatattgc gaaacagcgc cagattagct ttgtgaaaag ccattttagc
//
"""

KEGG = {
    "eco:b0002": "ENTRY       b0002             CDS       T00007\n"
                 "NAME        thrA\n"
                 "PATHWAY     eco00260  Glycine, serine and threonine "
                 "metabolism\n"
                 "            eco00270  Cysteine and methionine metabolism\n"
                 "            eco01100  Metabolic pathways\n"
                 "MODULE      eco_M00018  Threonine biosynthesis\n"
                 "///\n",
    "eco:b0003": "ENTRY       b0003             CDS       T00007\n"
                 "PATHWAY     eco00260  Glycine, serine and threonine "
                 "metabolism\n"
                 "///\n",
    "ecj:JW0002": "ENTRY       JW0002            CDS       T00068\n"
                  "NAME        thrB\n"
                  "///\n",
}
BIOCYC = {
    "EcoCyc:EG10998": '<?xml version="1.0"?><ptools-xml>'
                      '<Pathway ID="ECOLI:HOMOSER-THRESYN-PWY">'
                      '<common-name>L-threonine biosynthesis</common-name>'
                      '</Pathway><Pathway ID="ECOLI:THRESYN-PWY">'
                      '<common-name>superpathway of L-threonine '
                      'biosynthesis</common-name></Pathway></ptools-xml>',
    "EcoCyc:EG10999": "<ptools-xml><unclosed>",
}
ESEARCH = {
    "NC_TEST": "<?xml version=\"1.0\"?><eSearchResult><Count>2</Count>"
               "<IdList><Id>555001</Id><Id>555002</Id></IdList>"
               "</eSearchResult>",
    "NC_NONE": "<eSearchResult><Count>0</Count><IdList/></eSearchResult>",
}
ROUTES = {
    **{f"/kegg/get/{k}": v for k, v in KEGG.items()},
    **{f"/biocyc/apixml?fn=pathways-of-gene&id={k}": v
       for k, v in BIOCYC.items()},
    **{f"/eutils/esearch.fcgi?db=nucleotide&term={k}": v
       for k, v in ESEARCH.items()},
    "/eutils/efetch.fcgi?db=nucleotide&rettype=gb&id=555001": GENBANK,
}


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = ROUTES.get(self.path)
        self.server.log.append(self.path)
        if body is None:
            self.send_error(404)
            return
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def http_base():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.log = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server.log
    server.shutdown()
    server.server_close()


@pytest.fixture(autouse=True)
def fakes(monkeypatch, http_base):
    """Both modules' FTP and URLs on the fakes, and no proxy: urlopen
    builds its opener anew, from an environment that names none."""
    base, log = http_base
    monkeypatch.setattr(ftplib, "FTP", FakeFTP)
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "NCBI_EUTILS", base + "/eutils/")
        monkeypatch.setattr(mod, "KEGG_API", base + "/kegg")
        monkeypatch.setattr(mod, "BIOCYC_API", base + "/biocyc")
    for var in ("http_proxy", "https_proxy", "ftp_proxy", "all_proxy"):
        monkeypatch.delenv(var, raising=False)
        monkeypatch.delenv(var.upper(), raising=False)
    monkeypatch.setenv("no_proxy", "*")
    monkeypatch.setattr(urllib.request, "_opener", None)
    FakeFTP.LOG.clear()
    log.clear()
    return log


def _run_each(tmp_path, monkeypatch, capsys, http_log, fn, stdin=""):
    """fn(package, module) in a fresh directory per package, with stdin;
    returns {package: (result or the raised error's type and text,
    stdout, stderr, FTP calls, HTTP paths, {file: bytes})}."""
    got = {}
    for pkg, mod in MODULES.items():
        d = tmp_path / pkg
        d.mkdir(parents=True)
        monkeypatch.chdir(d)
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        FakeFTP.LOG.clear()
        http_log.clear()
        try:
            res = fn(pkg, mod)
        except Exception as e:  # compared between the packages
            res = (type(e).__name__, str(e))
        out = capsys.readouterr()
        files = {}
        for root, _, names in os.walk(d):
            for n in names:
                p = os.path.join(root, n)
                files[os.path.relpath(p, d)] = open(p, "rb").read()
        got[pkg] = (res, out.out, out.err, list(FakeFTP.LOG),
                    list(http_log), files)
    return got


# ---------------------------------------------------------------------------
# downloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("output", ["sub/uniprot.dat.gz", ""])
def test_download_uniprot_equals_jax(tmp_path, monkeypatch, capsys, fakes,
                                    output):
    """LICENSE beside the output, swissprot then trembl concatenated
    into it (default name uniprotkb-<taxon>.dat.gz), the same messages
    and FTP calls."""
    def run(pkg, mod):
        if output:
            os.makedirs("sub", exist_ok=True)
        return mod.download_uniprot(output, "bacteria")

    got = _run_each(tmp_path, monkeypatch, capsys, fakes, run)
    assert got["torch"] == got["jax"]
    files = got["torch"][5]
    name = output or "uniprotkb-bacteria.dat.gz"
    assert files[name] == (
        FTP_FILES[("ftp.uniprot.org", UNIPROT + "uniprot_sprot_bacteria"
                   ".dat.gz")]
        + FTP_FILES[("ftp.uniprot.org", UNIPROT + "uniprot_trembl_bacteria"
                     ".dat.gz")])
    assert files[os.path.join(os.path.dirname(output), "LICENSE")
                 if output else "LICENSE"].startswith(b"Creative")
    assert "# Downloading uniprotkb - trembl (bacteria).." in got["torch"][1]


@pytest.mark.parametrize("output", ["refseq.gpff.gz", ""])
def test_download_refseq_equals_jax(tmp_path, monkeypatch, capsys, fakes,
                                   output):
    """Only the *.nonredundant_protein.*.gpff.gz files of the release
    listing, in its order, concatenated."""
    got = _run_each(tmp_path, monkeypatch, capsys, fakes,
                    lambda pkg, mod: mod.download_refseq(output, "bacteria"))
    assert got["torch"] == got["jax"]
    want = b"".join(FTP_FILES[("ftp.ncbi.nlm.nih.gov", f"{REFSEQ_DIR}/{n}")]
                    for n in REFSEQ_NAMES
                    if ".nonredundant_protein." in n
                    and n.endswith(".gpff.gz"))
    assert got["torch"][5] == {output or "refseq-bacteria.gpff.gz": want}
    assert got["torch"][1].count("# Downloading ") == 2


@pytest.mark.parametrize("source,taxon", [
    ("download_uniprot", "bacterium"), ("download_uniprot", "viral"),
    ("download_refseq", "viruses"), ("download_refseq", ""),
])
def test_invalid_taxon_errors_equal_jax(tmp_path, monkeypatch, capsys,
                                        fakes, source, taxon):
    got = _run_each(tmp_path, monkeypatch, capsys, fakes,
                    lambda pkg, mod: getattr(mod, source)("out", taxon))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("ValueError", "Invalid taxon !")
    assert got["torch"][5] == {} and got["torch"][3] == []


def test_download_genbank_genome_equals_jax(tmp_path, monkeypatch, capsys,
                                           fakes):
    """esearch, efetch of the first id into <id>.gbk, then its CDS
    table; a term with no record raises the same ValueError."""
    got = _run_each(tmp_path, monkeypatch, capsys, fakes,
                    lambda pkg, mod: mod.download_genbank_genome("NC_TEST"))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "NC_TEST.tsv"
    assert got["torch"][5]["NC_TEST.gbk"] == GENBANK.encode()
    assert got["torch"][4] == [
        "/eutils/esearch.fcgi?db=nucleotide&term=NC_TEST",
        "/eutils/efetch.fcgi?db=nucleotide&rettype=gb&id=555001"]
    none = _run_each(tmp_path / "none", monkeypatch, capsys, fakes,
                     lambda pkg, mod: mod.download_genbank_genome("NC_NONE"))
    assert none["torch"] == none["jax"]
    assert none["torch"][0] == ("ValueError",
                                "no nucleotide record found for NC_NONE")


def test_parse_genbank_cds_equals_jax(tmp_path, monkeypatch, capsys, fakes):
    """Multi-line /product and /translation joined, a CDS with no
    protein id dropped, the same TSV bytes."""
    def run(pkg, mod):
        with open("genome.gbk", "w") as f:
            f.write(GENBANK)
        return mod.parse_genbank_cds("genome.gbk")

    got = _run_each(tmp_path, monkeypatch, capsys, fakes, run)
    assert got["torch"] == got["jax"]
    rows = got["torch"][5]["genome.tsv"].decode().splitlines()
    assert rows[0] == "EntryID\tGeneName\tProteinName\tSequence"
    assert rows[1].split("\t")[:3] == [
        "WP_000001.1", "abcD",
        "ATP-binding cassette domain-containing proteinwith a long name"]
    assert rows[1].split("\t")[3].startswith("MKTAYIAKQRQ")
    assert rows[1].endswith("ACRESVPALLE")
    assert rows[2] == ("WP_000002.1\tefgH\thypothetical protein\t"
                       "MSTNPKPQRKTKRNTNRRPQDVKFPGG")
    assert len(rows) == 3


# ---------------------------------------------------------------------------
# pathway annotation
# ---------------------------------------------------------------------------


def _seq(rng, n):
    return "".join(rng.choice(list(AA), size=n))


@pytest.fixture(scope="module")
def uniprot_db(tmp_path_factory):
    """A database built from a UniProt flat file whose entries carry
    DR KEGG; and DR BioCyc; cross-references: one id each, two KEGG ids
    (the last with pathways wins), none, an id the server answers 404,
    and a BioCyc id whose XML does not parse."""
    rng = np.random.default_rng(12)
    entries = [
        ("THRA_ECOLI", ["KEGG; eco:b0002; -.", "BioCyc; EcoCyc:EG10998; -."]),
        ("THRB_ECOLI", ["KEGG; eco:b0003; -.", "KEGG; ecj:JW0002; -."]),
        ("NOXR_ECOLI", []),
        ("MISS_ECOLI", ["KEGG; eco:b9999; -.", "BioCyc; EcoCyc:EG10999; -."]),
        ("THRC_ECOLI", ["BioCyc; EcoCyc:EG10998; -."]),
    ]
    tmp = tmp_path_factory.mktemp("uniprot_db")
    seqs = []
    with open(tmp / "db.dat", "w") as f:
        for name, drs in entries:
            s = _seq(rng, int(rng.integers(60, 120)))
            seqs.append(s)
            f.write(f"ID   {name}   Reviewed;   {len(s)} AA.\n"
                    f"DE   RecName: Full=Protein {name};\n"
                    f"GN   Name={name.split('_')[0].lower()};\n"
                    f"OS   Escherichia coli (strain K12).\n"
                    f"OX   NCBI_TaxID=83333;\n")
            for dr in drs:
                f.write(f"DR   {dr}\n")
            f.write(f"SQ   SEQUENCE   {len(s)} AA;  1 MW;  0 CRC64;\n")
            for i in range(0, len(s), 60):
                f.write("     " + s[i:i + 60] + "\n")
            f.write("//\n")
    build_db(str(tmp / "db"), str(tmp / "db.dat"), "embl")
    with open(tmp / "q.fasta", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">q{i}\n{s[5:70]}\n")
    return str(tmp / "db"), str(tmp / "q.fasta")


FEATURES = ("features.bin", "features.off.npy")  # the features blob


def _features(read):
    """The features blob's two files, read(name) each."""
    return tuple(read(n) for n in FEATURES)


def _search(pkg, db, qfasta, fmt):
    if pkg == "jax":
        return b"".join(jax_run_search(JaxEngine(jax_load_db(db)), JaxOptions(
            File=qfasta, SequenceType=PROTEIN, OutFormat=fmt,
            Annotations=True)))
    return b"".join(run_search(SearchEngine(load_db(db), "cpu"),
                               SearchOptions(File=qfasta,
                                             SequenceType=PROTEIN,
                                             OutFormat=fmt,
                                             Annotations=True)))


@pytest.mark.parametrize("answer", ["y", "n"])
@pytest.mark.parametrize("source", ["kegg", "biocyc"])
def test_annotation_equals_jax(uniprot_db, tmp_path, monkeypatch, capsys,
                               fakes, source, answer):
    """download_kegg / download_biocyc on copies of one database, the
    license prompt answered on stdin: the same messages, requests and
    features blob; accepted, the JSON search output of each package's
    engine over its own copy is the same and holds the pathways, which
    the TSV (db_stats.Features is not extended) does not."""
    db, qfasta = uniprot_db
    before = _features(lambda n: open(os.path.join(db, n), "rb").read())

    def run(pkg, mod):
        shutil.copytree(db, "db")
        return getattr(mod, f"download_{source}")("db")

    got = _run_each(tmp_path, monkeypatch, capsys, fakes, run,
                    stdin=answer + "\n")
    assert got["torch"] == got["jax"]
    res, out, _, _, requests, files = got["torch"]
    assert res is None
    assert "Do you accept" in out
    feats = _features(lambda n: files[os.path.join("db", n)])
    field = {"kegg": "KEGG_Pathways", "biocyc": "BioCyc_Pathways"}[source]
    if answer == "n":
        assert feats == before and requests == []
        assert "I am sorry you couldn't accept that license" in out
        return
    assert feats != before and field.encode() in feats[0]
    assert len(requests) == (4 if source == "kegg" else 3)
    bodies = {pkg: {fmt: _search(pkg, str(tmp_path / pkg / "db"), qfasta, fmt)
                    for fmt in ("json", "tsv")} for pkg in MODULES}
    assert bodies["torch"] == bodies["jax"]
    assert field.encode() in bodies["torch"]["json"]
    assert field.encode() not in bodies["torch"]["tsv"]
    if source == "kegg":
        assert (b"Glycine, serine and threonine metabolism [eco00260];"
                b"Cysteine and methionine metabolism [eco00270]"
                in bodies["torch"]["json"])


# ---------------------------------------------------------------------------
# kaamer-db -download
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,stdin", [
    (["-download"], ""),
    (["-download", "-kegg"], ""),
    (["-download", "-biocyc"], ""),
    (["-download", "-uniprot", "bacteria", "-o", "up.dat.gz"], ""),
    (["-download", "-uniprot", "bacteria"], ""),
    (["-download", "-refseq", "bacteria", "-o", "rs.gpff.gz"], ""),
    (["-download", "-ncbi_nt", "NC_TEST"], ""),
    (["-download", "-kegg", "-d", "db"], "y\n"),
    (["-download", "-biocyc", "-d", "db"], "n\n"),
    (["-download", "-uniprot", "bacterium"], ""),
    (["-download", "-uniprot", "bacteria", "-kegg", "-d", "db"], ""),
], ids=lambda a: " ".join(a).strip() if isinstance(a, list) else None)
def test_db_download_cli_equals_jax(uniprot_db, tmp_path, monkeypatch,
                                    capsys, fakes, argv, stdin):
    """kaamer_db_main -download: the same stdout, return code (or
    error), requests and files as kaamer_tpu.cli's, with its checks in
    its order (-uniprot before -refseq, -kegg, -biocyc, -ncbi_nt)."""
    db, _ = uniprot_db

    def run(pkg, mod):
        if "db" in argv:
            shutil.copytree(db, "db")
        return MAINS[pkg](argv)

    got = _run_each(tmp_path, monkeypatch, capsys, fakes, run, stdin=stdin)
    assert got["torch"] == got["jax"]
    res, out = got["torch"][:2]
    if argv == ["-download"]:
        assert (res, out) == (1, "Need uniprot, refseq, kegg or biocyc "
                                 "option !\n")
    elif len(argv) == 2:
        assert (res, out) == (1, "No input db path !\n")
    elif "bacterium" in argv:
        assert res == ("ValueError", "Invalid taxon !")
    else:
        assert res == 0
