"""Torch port vs JAX: translated (nucleotide and FASTQ) search, byte for
byte on the same database directory, on the fixtures of test_fastq_nt.py,
test_fuzz_nucleotide.py, test_orf.py and test_pipeline.py (CPU tensors);
and the port's ORF scan (native and Python) against the JAX package's for
every genetic code."""

import functools

import numpy as np
import pytest

import kaamer_tpu.ops.swalign_pallas as swalign_pallas
from kaamer_tpu import native as jax_native
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.search import gcode as jax_gcode
from kaamer_tpu.search import orf as jax_orf
from kaamer_tpu.search import pipeline as jax_pipeline
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.search.options import SearchOptions as JaxOptions
from kaamer_tpu_torch import native
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.ops import swalign as torch_swalign
from kaamer_tpu_torch.search import gcode, orf, pipeline
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.search.options import (NUCLEOTIDE, READS,
                                             SearchOptions)
from tests_codon_helper import encode_protein

AA = "ACDEFGHIKMNPQRSTVWY"  # no L: reverse translation stays start-free
BLAN1 = (
    "MELPNIMHPVAKLSTALAAALMLSGCMPGEIRPTIGQQMETGDQRFGDLVFRQLAPNVWQHTSYLDMPGFGAVASNGLIV"
    "RDGGRVLVVDTAWTDDQTAQILNWIKQEINLPVALAVVTHAHQDKMGGMDALHAAGIATYANALSNQLAPQEGMVAAQHS"
    "LTFAANGWVEPATAPNFGPLKVFYPGPGHTSDNITVGIDGTDIAFGGCLIKDSKAKSLGNLGDADTEHYAASARAFGAAF"
    "PKASMIVMSHSAPDSRAAITHTARMADKLR"
)


def _engines(dbdir):
    return (SearchEngine(load_db(dbdir), "cpu"),
            JaxEngine(jax_load_db(dbdir)))


def _reads(rng, seqs, n=60):
    """test_fastq_nt.py's lean-path reads: fragments with Met/Leu starts,
    a third on the minus strand, a fifth junk."""
    reads = []
    for i in range(n):
        src = seqs[int(rng.integers(0, len(seqs)))]
        start = int(rng.integers(0, max(len(src) - 45, 1)))
        dna = "taa" + encode_protein("MV" + src[start:start + 40] + "LM") \
            + "taa"
        if i % 3 == 0:
            dna = orf.reverse_complement(dna)
        if i % 5 == 0:
            dna = "".join(rng.choice(list("acgt"), size=len(dna)))
        reads.append(dna)
    return reads


def _genomic(rng, seqs):
    """test_fuzz_nucleotide.py's records: 1-2 reverse-translated fragments
    on random strands between random bases."""
    parts = ["".join(rng.choice(list("acgt"), size=int(rng.integers(5, 40))))]
    for _ in range(int(rng.integers(1, 3))):
        prot = seqs[int(rng.integers(0, len(seqs)))]
        lo = int(rng.integers(0, max(1, len(prot) - 30)))
        dna = "atg" + encode_protein(prot[lo:lo + int(rng.integers(25, 70))]) \
            + "taa"
        if rng.integers(0, 2):
            dna = orf.reverse_complement(dna)
        parts.append(dna)
        parts.append("".join(rng.choice(list("acgt"),
                                        size=int(rng.integers(5, 40)))))
    return "".join(parts)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """name -> (port engine, JAX engine, {query file name: path}).
    'fq': test_fastq_nt.py's database and reads; 'nt':
    test_fuzz_nucleotide.py's database and genomic records; 'blan':
    test_pipeline.py's database (random proteins and BLAN1) with a gene of
    a BLAN1 fragment."""
    out = {}
    for name, seed, n, lo, hi in (("fq", 31, 25, 60, 160),
                                  ("nt", 55, 30, 50, 140)):
        rng = np.random.default_rng(seed)
        tmp = tmp_path_factory.mktemp(f"tr_{name}")
        seqs = ["M" + "".join(rng.choice(list(AA),
                                         size=int(rng.integers(lo, hi))))
                for _ in range(n)]
        with open(tmp / "db.fasta", "w") as f:
            f.writelines(f">{name.upper()}{i} prot {i}\n{s}\n"
                         for i, s in enumerate(seqs))
        build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")
        qrng = np.random.default_rng(77 if name == "fq" else 91)
        if name == "fq":
            reads = _reads(qrng, seqs)
            files = {"reads.fq": "".join(
                f"@r{i}\n{d}\n+\n{'I' * len(d)}\n"
                for i, d in enumerate(reads)),
                "reads.fasta": "".join(f">c{i} nt\n{d}\n"
                                       for i, d in enumerate(reads))}
        else:
            files = {"genes.fasta": "".join(
                f">g{i}\n{_genomic(qrng, seqs)}\n" for i in range(30)),
                "few.fasta": "".join(
                f">g{i}\n{_genomic(qrng, seqs)}\n" for i in range(4))}
        paths = {}
        for fn, text in files.items():
            (tmp / fn).write_text(text)
            paths[fn] = str(tmp / fn)
        out[name] = (*_engines(str(tmp / "db")), paths)

    rng = np.random.default_rng(3)
    tmp = tmp_path_factory.mktemp("tr_blan")
    with open(tmp / "db.fasta", "w") as f:
        for i in range(20):
            seq = "".join(rng.choice(list(AA + "L"),
                                     size=int(rng.integers(50, 200))))
            f.write(f">RND{i}_TEST random protein {i}\n{seq}\n")
        f.write(f">BLAN1_KLEPN Metallo-beta-lactamase type 2\n{BLAN1}\n")
    build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")
    gene = "ccc" + "taa" + encode_protein("M" + BLAN1[1:100]) + "taa" + "gg"
    (tmp / "gene.fasta").write_text(f">contig1 test\n{gene}\n")
    out["blan"] = (*_engines(str(tmp / "db")),
                   {"gene.fasta": str(tmp / "gene.fasta")})
    return out


def _both(dbs, name, fn, **kw):
    """run_search bytes of the port and of the JAX package on one query
    file with the same options."""
    port, jax_engine, paths = dbs[name]
    seq_type = READS if fn.endswith(".fq") else NUCLEOTIDE
    got = b"".join(pipeline.run_search(port, SearchOptions(
        File=paths[fn], SequenceType=seq_type, **kw)))
    want = b"".join(jax_pipeline.run_search(jax_engine, JaxOptions(
        File=paths[fn], SequenceType=seq_type, **kw)))
    return got, want


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("out_format", ["tsv", "json"])
@pytest.mark.parametrize("name,fn", [("nt", "genes.fasta"),
                                     ("blan", "gene.fasta")])
def test_nucleotide_bytes_equal_jax(dbs, name, fn, out_format, positions):
    got, want = _both(dbs, name, fn, OutFormat=out_format,
                      ExtractPositions=positions, MaxResults=5)
    assert got == want
    if name == "blan":
        assert b"BLAN1_KLEPN" in got
    else:
        assert got.count(b"NT") > 3


@pytest.mark.parametrize("out_format", ["tsv", "json"])
def test_nucleotide_aln_bytes_equal_jax(dbs, out_format, monkeypatch):
    """-aln of translated hits: the port's sw_align (its plain version on
    the CPU) vs the JAX package's Pallas kernel in interpret mode."""
    monkeypatch.setattr(swalign_pallas, "sw_batch_dispatch", functools.partial(
        swalign_pallas.sw_batch_dispatch, interpret=True))
    host_before = torch_swalign.HOST_DP_PAIRS
    got, want = _both(dbs, "nt", "few.fasta", OutFormat=out_format,
                      Align=True, MaxResults=2)
    assert got == want
    assert got.count(b"NT") > 3
    assert torch_swalign.HOST_DP_PAIRS == host_before  # went to sw_align


@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("fn", ["reads.fq", "reads.fasta"])
def test_reads_lean_and_generic_bytes_equal_jax(dbs, fn, lean, monkeypatch):
    """The plain-TSV translated path (LEAN_NT_TSV) and the generic path
    (forced on both packages) give the JAX package's bytes, and each
    other's."""
    monkeypatch.setattr(pipeline, "LEAN_NT_TSV", lean)
    monkeypatch.setattr(jax_pipeline, "LEAN_NT_TSV", lean)
    calls = []
    monkeypatch.setattr(pipeline, "_nucleotide_search_lean_tsv",
                        lambda *a, _f=pipeline._nucleotide_search_lean_tsv,
                        **kw: calls.append(1) or _f(*a, **kw))
    got, want = _both(dbs, "fq", fn, MaxResults=3)
    assert got == want
    assert got.count(b"\n") > 10
    assert bool(calls) == lean
    monkeypatch.setattr(pipeline, "LEAN_NT_TSV", not lean)
    other, _ = _both(dbs, "fq", fn, MaxResults=3)
    assert other == got


@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("min_kmatch,rows", [(20, 47), (40, 21), (60, 1)])
def test_min_top_gating_bytes_equal_jax(dbs, min_kmatch, rows, lean,
                                        monkeypatch):
    """The engine's min_top gate (MinKMatch) drops the same ORFs in both
    packages, on the lean and the generic path."""
    monkeypatch.setattr(pipeline, "LEAN_NT_TSV", lean)
    monkeypatch.setattr(jax_pipeline, "LEAN_NT_TSV", lean)
    got, want = _both(dbs, "nt", "genes.fasta", MinKMatch=min_kmatch,
                      MaxResults=4)
    assert got == want
    assert got.count(b"\n") - 1 == rows


def _random_dna(seed):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("acgt"), size=L))
            for L in (0, 1, 2, 3, 62, 63, 64, 65, 150, 151, 152, 300, 1000,
                      3000)]
    seqs.append("ATGaaaNNNtttTAGatg" + "gca" * 30 + "taa")
    seqs.append("atg" + "aaa" * 25 + "tag" + "ccc" * 10 + "atg" + "ggg" * 30)
    return seqs


def _no_native(monkeypatch, mod):
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_tried", True)


@pytest.mark.parametrize("scan", ["native", "python"])
@pytest.mark.parametrize("gcode_id", jax_gcode.VALID_GCODES)
def test_orf_scan_equals_jax(gcode_id, scan, monkeypatch):
    """get_orf_tuples_batch and get_orfs (and the translation tables) of
    the port equal the JAX package's on random DNA, with the native
    scanner and with the Python scan."""
    assert gcode.VALID_GCODES == jax_gcode.VALID_GCODES
    for a, b in zip(gcode.translation_arrays(gcode_id),
                    jax_gcode.translation_arrays(gcode_id)):
        np.testing.assert_array_equal(a, b)
    if scan == "python":
        _no_native(monkeypatch, native)
        _no_native(monkeypatch, jax_native)
    elif not native.available():
        pytest.skip("no native library (g++ missing)")
    assert native.available() == (scan == "native")
    seqs = _random_dna(gcode_id)
    for min_kmers in (0, 1, 20):
        got = orf.get_orf_tuples_batch(seqs, gcode_id, min_kmers=min_kmers)
        assert got == jax_orf.get_orf_tuples_batch(seqs, gcode_id,
                                                   min_kmers=min_kmers)
    assert sum(map(len, got)) > 10
    for s in seqs[-6:]:
        mine, theirs = orf.get_orfs(s, gcode_id), jax_orf.get_orfs(s, gcode_id)
        assert [(o.Sequence, o.Location.StartPosition, o.Location.EndPosition,
                 o.Location.PlusStrand, o.Location.StartsAlternative)
                for o in mine] == [
                (o.Sequence, o.Location.StartPosition, o.Location.EndPosition,
                 o.Location.PlusStrand, o.Location.StartsAlternative)
                for o in theirs]
