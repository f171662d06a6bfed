"""The port's database lifecycle (kaamer_tpu_torch.index.merge, .backup and
the kaamer-db CLI) against the JAX package's, exactly: the same CLI steps
on the same FASTA write the same bytes in every output directory, print
the same messages and return the same codes; the merged-and-indexed
database serves JAX's run_search bytes."""

import filecmp
import os

import numpy as np
import pytest
import torch

from kaamer_tpu import cli as jax_cli
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.search.pipeline import run_search as jax_run_search
from kaamer_tpu.server.app import _default_options as jax_default_options
from kaamer_tpu_torch import cli
from kaamer_tpu_torch.index import build, merge
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.search.options import PROTEIN
from kaamer_tpu_torch.search.pipeline import run_search
from kaamer_tpu_torch.server.app import _default_options

AA = "ACDEFGHIKLMNPQRSTVWY"
MAINS = {"jax": jax_cli.kaamer_db_main, "torch": cli.kaamer_db_main}
OUTPUTS = ("parts/a", "parts/b", "merged", "bkp", "rst")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """48 proteins of shared domains and random linkers (so that sets are
    shared and several k-mers split between the halves), and 6 queries."""
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("lifecycle")
    doms = ["".join(rng.choice(list(AA), size=int(rng.integers(20, 40))))
            for _ in range(6)]
    seqs = []
    for _ in range(48):
        parts = [doms[int(rng.integers(0, 6))]
                 for _ in range(int(rng.integers(1, 3)))]
        parts.append("".join(rng.choice(list(AA),
                                        size=int(rng.integers(10, 60)))))
        rng.shuffle(parts)
        seqs.append("".join(parts))
    (tmp / "in.fasta").write_text("".join(
        f">P{i} lifecycle {i}\n{s}\n" for i, s in enumerate(seqs)))
    (tmp / "q.fasta").write_text("".join(
        f">q{i}\n{seqs[j][:70]}\n" for i, j in enumerate((3, 11, 25, 30,
                                                          40, 47))))
    return tmp


def _lifecycle(main, root, fasta_path, capsys, monkeypatch, shards):
    """The documented split build (docs/database.md:78-101) through one
    package's kaamer-db, in root: two -noindex halves, -merge, -index,
    -backup, -restore, -gc.  Returns each step's (code, stdout)."""
    os.makedirs(root)
    monkeypatch.chdir(root)
    make = ["-make", "-i", fasta_path, "-f", "fasta", "-noindex"]
    steps = [make + ["-d", "parts/a", "-offset", "0", "-length", "20"],
             make + ["-d", "parts/b", "-offset", "20"],
             ["-merge", "-dbs", "parts", "-o", "merged"],
             ["-index", "-d", "merged", "-shards", str(shards)],
             ["-backup", "-d", "merged", "-o", "bkp"],
             ["-restore", "-d", "bkp", "-o", "rst"],
             ["-gc", "-d", "rst"]]
    out = []
    for argv in steps:
        out.append((main(argv), capsys.readouterr().out))
    return out


def _same_tree(a, b):
    """Every file of directory a equals b's, byte for byte, its
    subdirectories (the shards of a shard-built index) included."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    dirs = [n for n in names if os.path.isdir(os.path.join(a, n))]
    files = [n for n in names if n not in dirs]
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, (a, mismatch, errors)
    for d in dirs:
        _same_tree(os.path.join(a, d), os.path.join(b, d))


@pytest.mark.parametrize("shards,block", [(0, merge.BLOCK_ELEMS), (0, 7),
                                          (2, merge.BLOCK_ELEMS)],
                         ids=["global", "blocks-of-7", "shard-built"])
def test_lifecycle_bytes_equal_jax(fasta, tmp_path, capsys, monkeypatch,
                                   shards, block):
    """Each step's output directory, message and code equal JAX's; a block
    of 7 pairs makes the stream merge take dozens of blocks an input."""
    monkeypatch.setattr(merge, "BLOCK_ELEMS", block)
    got = {pkg: _lifecycle(main, tmp_path / pkg, str(fasta / "in.fasta"),
                           capsys, monkeypatch, shards)
           for pkg, main in MAINS.items()}
    assert got["torch"] == got["jax"]
    assert all(code == 0 for code, _ in got["torch"])
    assert "# Merging database parts/b into merged..." in got["torch"][2][1]
    for d in OUTPUTS:
        _same_tree(tmp_path / "jax" / d, tmp_path / "torch" / d)
    rst = load_db(str(tmp_path / "torch" / "rst"))
    assert rst.indexed and rst.num_proteins == 48
    assert rst.index_shards == shards
    if shards:
        assert sorted(n for n in os.listdir(tmp_path / "torch" / "bkp")
                      if n.startswith("shard")) == ["shard00", "shard01"]


def test_merge_streams_in_blocks(fasta, tmp_path, monkeypatch):
    """The merge reads its inputs in blocks: with blocks of 5 pairs,
    _kway_merge_u64 reads every input many times, never a whole array,
    and the merged pairs are the sorted rebased union."""
    monkeypatch.setattr(merge, "BLOCK_ELEMS", 5)
    reads = []
    real = np.fromfile

    def fromfile(f, *args, **kw):
        if getattr(f, "name", "").endswith("pairs.npy"):
            reads.append(kw["count"])
        return real(f, *args, **kw)

    monkeypatch.setattr(build.np, "fromfile", fromfile)
    monkeypatch.chdir(tmp_path)
    for argv in (["-d", "p/a", "-offset", "0", "-length", "30"],
                 ["-d", "p/b", "-offset", "30"]):
        assert cli.kaamer_db_main(["-make", "-i", str(fasta / "in.fasta"),
                                   "-f", "fasta", "-noindex"] + argv) == 0
    merge.merge_dbs("p", "m")
    a, b, m = (load_db(p) for p in ("p/a", "p/b", "m"))
    pairs_b = np.asarray(b.pairs)
    rebased = (pairs_b & ~np.uint64(0xFFFFFFFF)) | (
        (pairs_b & np.uint64(0xFFFFFFFF)) + np.uint64(a.num_proteins))
    want = np.sort(np.concatenate([np.asarray(a.pairs), rebased]))
    np.testing.assert_array_equal(np.asarray(m.pairs), want)
    assert reads and max(reads) == 5
    assert sum(reads) == want.size


def test_merged_db_serves_jax_bytes(fasta, tmp_path, capsys, monkeypatch):
    """run_search on the port's merged, indexed and restored database
    equals the JAX engine's on JAX's, TSV and JSON with positions."""
    for pkg, main in MAINS.items():
        _lifecycle(main, tmp_path / pkg, str(fasta / "in.fasta"), capsys,
                   monkeypatch, 0)
    engine = SearchEngine(load_db(str(tmp_path / "torch" / "rst")), "cpu")
    jax_engine = JaxEngine(jax_load_db(str(tmp_path / "jax" / "rst")))
    for out_format, positions in (("tsv", False), ("json", True)):
        bodies = []
        for eng, defaults, run in ((engine, _default_options, run_search),
                                   (jax_engine, jax_default_options,
                                    jax_run_search)):
            o = defaults(PROTEIN)
            o.File, o.OutFormat = str(fasta / "q.fasta"), out_format
            o.ExtractPositions = positions
            bodies.append(b"".join(run(eng, o)))
        assert bodies[0] == bodies[1]
        assert bodies[0].count(b"\n") > 6 or out_format == "json"


# kaamer-db error branches: messages and codes
DB_ERRORS = [
    [], ["-server"], ["-make"], ["-make", "-d", "x"],
    ["-make", "-d", "x", "-i", "in.fasta"], ["-index"], ["-merge"],
    ["-merge", "-dbs", "parts"], ["-merge", "-o", "out"], ["-gc"],
    ["-backup"], ["-backup", "-d", "x"], ["-restore"], ["-restore", "-d", "x"],
]


@pytest.mark.parametrize("argv", DB_ERRORS, ids=lambda a: " ".join(a) or "none")
def test_db_cli_messages_equal_jax(argv, capsys):
    """Every branch that prints and returns: the same stdout and code
    (with no program, both print their help and return 0: the help texts
    differ by -device)."""
    got = {}
    for pkg, main in MAINS.items():
        code = main(argv)
        got[pkg] = (code, capsys.readouterr().out)
    if argv:
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == 1
    else:
        assert got["torch"][0] == got["jax"][0] == 0
        assert got["torch"][1].startswith("usage: kaamer-db")


def _indexed(tmp):
    os.makedirs(tmp / "dbs" / "whole")
    (tmp / "in.fasta").write_text(">P0\nMKTAYIAKQRQISFVKSHFSRQ\n"
                                  ">P1\nMKTAYIAKQRQISFVKSHFSRW\n")
    build.build_db(str(tmp / "dbs" / "whole"), str(tmp / "in.fasta"))


def _duplicate_ids(tmp):
    for d in ("a", "b"):
        build.build_db(str(tmp / "dbs" / d), str(tmp / "in.fasta"),
                       no_index=True)


@pytest.mark.parametrize("argv,setup", [
    (["-merge", "-dbs", "dbs", "-o", "out"], None),
    (["-merge", "-dbs", "dbs", "-o", "out"], _indexed),
    (["-merge", "-dbs", "dbs", "-o", "out"], _duplicate_ids),
    (["-index", "-d", "dbs/whole"], _indexed),
    (["-backup", "-d", "dbs", "-o", "out"], None),
    (["-restore", "-d", "dbs", "-o", "out"], None),
], ids=["no-databases", "indexed-input", "duplicate-ids", "indexed-again",
        "backup-not-a-db", "restore-not-a-backup"])
def test_db_cli_errors_equal_jax(argv, setup, tmp_path, monkeypatch, capsys):
    """The branches that raise: the same exception and message in both,
    and the same stdout before it."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("dbs", exist_ok=True)
    (tmp_path / "in.fasta").write_text(">P0\nMKTAYIAKQRQISFVKSHFSRQ\n")
    if setup is _duplicate_ids:
        _duplicate_ids(tmp_path)
    elif setup is not None:
        setup(tmp_path)
    got = {}
    for pkg, main in MAINS.items():
        with pytest.raises(ValueError) as e:
            main(argv)
        got[pkg] = (str(e.value), capsys.readouterr().out)
        assert not os.path.exists("out")
    assert got["torch"] == got["jax"]


def test_db_parser_options_equal_jax():
    """The same option strings, destinations and defaults, the download
    flags included, except the port's -device."""
    def options(parser):
        return {tuple(a.option_strings): (a.dest, a.default)
                for a in parser._actions}

    port, ref = options(cli._db_parser()), options(jax_cli._db_parser())
    download = {("-download",), ("-uniprot",), ("-refseq",), ("-ncbi_nt",),
                ("-kegg",), ("-biocyc",)}
    assert set(port) - set(ref) == {("-device",)}
    assert set(ref) - set(port) == set()
    assert download <= set(port)
    assert ref == {k: v for k, v in port.items() if k != ("-device",)}
    assert port[("-device",)] == ("device", "cuda")
    assert port[("-tmp",)] == ("tmp", "/tmp/")


def test_server_default_device_needs_a_card(fasta, tmp_path, monkeypatch):
    """db -server runs on cuda unless -device says otherwise; with no card
    it raises before it listens, instead of serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["db", "-make", "-i", str(fasta / "in.fasta"), "-f",
                     "fasta", "-d", "db"]) == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["db", "-server", "-d", "db", "-p", "0"])
