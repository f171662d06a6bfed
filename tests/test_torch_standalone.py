"""The torch port stands alone: no module of kaamer_tpu_torch, and not
chip_smoke.py, imports jax, the JAX package (kaamer_tpu) or the root
bench.py, directly or transitively; and the port's own copies of the host
code (the build, the skewed benchmark database, the codec packers, the
native packers) give the JAX package's bytes."""

import ast
import filecmp
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import bench
import kaamer_tpu_torch
from kaamer_tpu import codec as jax_codec
from kaamer_tpu.index.build import build_db as jax_build_db
from kaamer_tpu_torch import codec, native
from kaamer_tpu_torch.bench import data
from kaamer_tpu_torch.index.build import build_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "kaamer_tpu", "bench")
AA = "ACDEFGHIKLMNPQRSTVWY"


def _port_modules():
    return ["kaamer_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(kaamer_tpu_torch.__path__,
                                              "kaamer_tpu_torch."))


def _port_files():
    root = os.path.join(REPO, "kaamer_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "bin", "kaamer-torch"),
             os.path.join(REPO, "bin", "kaamer-db-torch")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_every_module_loads_no_jax_package():
    """A fresh interpreter imports every module of the port (walked with
    pkgutil) and chip_smoke: no jax, kaamer_tpu or bench module loads."""
    mods = _port_modules()
    assert len(mods) > 20 and {
        "kaamer_tpu_torch.index.build", "kaamer_tpu_torch.search.orf",
        "kaamer_tpu_torch.search.gcode", "kaamer_tpu_torch.upload",
        "kaamer_tpu_torch.bench.serving", "kaamer_tpu_torch.parallel.dist",
        "kaamer_tpu_torch.parallel.comm", "kaamer_tpu_torch.index.merge",
        "kaamer_tpu_torch.index.backup", "kaamer_tpu_torch.server.client",
        "kaamer_tpu_torch.bench.harness", "kaamer_tpu_torch.cli",
        "kaamer_tpu_torch.bench.entry", "kaamer_tpu_torch.bench.throughput",
        "kaamer_tpu_torch.bench.cpu_baseline"} <= set(mods)
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"kaamer_tpu_torch/search/orf.py",
            "kaamer_tpu_torch/search/gcode.py",
            "kaamer_tpu_torch/index/merge.py",
            "kaamer_tpu_torch/index/backup.py",
            "kaamer_tpu_torch/server/client.py",
            "kaamer_tpu_torch/bench/harness.py",
            "kaamer_tpu_torch/cli.py",
            "kaamer_tpu_torch/bench/entry.py",
            "kaamer_tpu_torch/bench/throughput.py",
            "kaamer_tpu_torch/bench/cpu_baseline.py",
            "bin/kaamer-torch", "bin/kaamer-db-torch"} <= files
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    """Every import statement of the file, those inside functions
    included, names neither jax, kaamer_tpu nor bench."""
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def _same_tree(a, b):
    """Every file of artifact directory a equals b's, byte for byte, its
    subdirectories (the shards of a sharded build) included."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    dirs = [n for n in names if os.path.isdir(os.path.join(a, n))]
    files = [n for n in names if n not in dirs]
    assert "hash_table.npy" in files or dirs
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for d in dirs:
        _same_tree(os.path.join(a, d), os.path.join(b, d))


@pytest.mark.parametrize("fmt", ["fasta", "tsv"])
def test_build_db_bytes_equal_jax(tmp_path, fmt):
    rng = np.random.default_rng(17)
    seqs = ["".join(rng.choice(list(AA), size=int(rng.integers(5, 200))))
            for _ in range(150)]
    src = tmp_path / f"in.{fmt}"
    with open(src, "w") as f:
        if fmt == "fasta":
            f.writelines(f">P{i} protein {i}\n{s}\n" for i, s in enumerate(seqs))
        else:
            f.write("EntryID\tSequence\tGene\n")
            f.writelines(f"P{i}\t{s}\tg{i % 7}\n" for i, s in enumerate(seqs))
    for d, build in (("a", jax_build_db), ("b", build_db)):
        os.makedirs(tmp_path / d)
        build(str(tmp_path / d / "db"), str(src), fmt)
    _same_tree(tmp_path / "a" / "db", tmp_path / "b" / "db")


def test_build_skewed_db_bytes_equal_bench(tmp_path):
    """The port's generator builds bench.py's seed-77 database, byte for
    byte (a few hundred proteins here; 1M on the card)."""
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    bench.build_skewed_db(str(tmp_path / "a" / "skew"), 300, 77)
    art = data.ensure_db(str(tmp_path / "b" / "skew"), data.build_skewed_db,
                         300, 77)
    _same_tree(tmp_path / "a" / "skew", tmp_path / "b" / "skew")
    assert art.num_proteins == 300
    want = bench.make_queries(art, np.random.default_rng(5), 20)
    assert data.make_queries(art, np.random.default_rng(5), 20) == want


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_build_bytes_equal_jax(tmp_path, n_shards):
    """build_db(n_shards) writes the JAX package's sharded artifact: one
    shardNN directory a shard, every file equal."""
    rng = np.random.default_rng(23)
    dom = "".join(rng.choice(list(AA), size=40))  # a set long enough to split
    src = tmp_path / "in.fasta"
    with open(src, "w") as f:
        for i in range(120):
            s = "".join(rng.choice(list(AA), size=int(rng.integers(20, 90))))
            f.write(f">P{i} protein {i}\n{dom if i % 2 else ''}{s}\n")
    for d, build in (("a", jax_build_db), ("b", build_db)):
        os.makedirs(tmp_path / d)
        build(str(tmp_path / d / "db"), str(src), "fasta", n_shards=n_shards)
    assert sorted(n for n in os.listdir(tmp_path / "b" / "db")
                  if n.startswith("shard")) == [f"shard{s:02d}"
                                                for s in range(n_shards)]
    _same_tree(tmp_path / "a" / "db", tmp_path / "b" / "db")


def test_host_codec_packers_equal_jax():
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list(AA + "UXB*"),
                               size=int(rng.integers(0, 40))))
            for _ in range(33)]
    width = 46
    pad = codec.pad_codes_batch(seqs, width)
    np.testing.assert_array_equal(pad, jax_codec.pad_codes_batch(seqs, width))
    np.testing.assert_array_equal(codec.pack_codes7(pad),
                                  jax_codec.pack_codes7(pad))
    np.testing.assert_array_equal(
        codec.encode_kmers_batch(pad.astype(np.int32)),
        jax_codec.encode_kmers_batch(pad.astype(np.int32)))
    for s in seqs:
        np.testing.assert_array_equal(
            codec.encode_kmers_np(codec.seq_to_codes(s)),
            jax_codec.encode_kmers(jax_codec.seq_to_codes(s)))


def test_native_pairs_equal_numpy_fallback(monkeypatch):
    """The native pair extraction and its numpy fallback (which runs
    where g++ is missing) give the same pairs."""
    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list(AA + "X"), size=int(rng.integers(3, 90))))
            for _ in range(40)]
    buf = np.frombuffer("".join(seqs).encode(), np.uint8)
    offs = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    if not native.available():
        pytest.skip("no native library (g++ missing)")
    got = native.extract_pairs(buf, offs, 100)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    np.testing.assert_array_equal(native.extract_pairs(buf, offs, 100), got)
