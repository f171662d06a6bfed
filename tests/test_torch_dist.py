"""The port's sharded serving (kaamer_tpu_torch.parallel) against the JAX
package's (kaamer_tpu.parallel), exactly (tolerance 0): the per-shard
index, the sharded totals and group steps on the conftest's 8 virtual JAX
CPU devices against port grids of "cpu", run_search bytes of both sharded
engines and the port's single-device engine over both artifact layouts,
the host fallback, split sets, the shard-built guards, the
dryrun_multichip twin, and sharded serving through the server and the
CLI."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

import kaamer_tpu.ops.swalign_pallas as swalign_pallas
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.parallel import dist as jax_dist
from kaamer_tpu.parallel import mesh as jax_mesh
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.search.options import SearchOptions as JaxOptions
from kaamer_tpu.search.pipeline import run_search as jax_run_search
from kaamer_tpu_torch import cli, codec
from kaamer_tpu_torch.bench import data
from kaamer_tpu_torch.bench.multichip import device_grid, dryrun_multichip
from kaamer_tpu_torch.bench.serving import Served, post
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.parallel import mesh
from kaamer_tpu_torch.parallel.dist import (Mesh, ShardedSearchEngine,
                                            global_mesh)
from kaamer_tpu_torch.search import engine as engine_mod
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.search.options import (NUCLEOTIDE, PROTEIN, READS,
                                             SearchOptions)
from kaamer_tpu_torch.search.pipeline import run_search
from kaamer_tpu_torch.server import app
from tests_codon_helper import encode_protein

AA = "ACDEFGHIKLMNPQRSTVWY"
# (dp, shard) grids of the port, each with its JAX mesh of as many of the
# conftest's virtual devices
GRIDS = {"1x4": (1, 4), "2x2": (2, 2), "2x4": (2, 4)}


def _grid(name):
    dp, n = GRIDS[name]
    return [["cpu"] * n for _ in range(dp)]


def _jax_mesh(name):
    dp, n = GRIDS[name]
    return JaxMesh(np.array(jax.devices()[: dp * n]).reshape(dp, n),
                   axis_names=("dp", "shard"))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """test_dist.py's built_shards at 300 proteins (so that every shard of
    2 and of 4 holds hot sets): one domain-skewed fasta built as a global
    artifact and as a 4-shard build, plus protein, nucleotide and FASTQ
    query files (reverse-translated database fragments)."""
    rng = np.random.default_rng(31)
    domains = ["".join(rng.choice(list(AA), size=int(rng.integers(25, 50))))
               for _ in range(5)]
    seqs = []
    tmp = tmp_path_factory.mktemp("torch_shards")
    with open(tmp / "in.fasta", "w") as f:
        for i in range(300):
            parts = [d for j, d in enumerate(domains)
                     if rng.random() < 1.0 / (j + 2)]
            parts.append("".join(rng.choice(list(AA),
                                            size=int(rng.integers(30, 70)))))
            rng.shuffle(parts)
            s = "".join(parts)
            seqs.append(s)
            f.write(f">S{i} sharded build {i}\n{s}\n")
    build_db(str(tmp / "gdb"), str(tmp / "in.fasta"), "fasta")
    build_db(str(tmp / "sdb"), str(tmp / "in.fasta"), "fasta", n_shards=4)
    qrng = np.random.default_rng(8)
    files = {
        "q.fasta": "".join(f">q{i}\n{seqs[i]}\n" for i in (0, 9, 33))
        + ">hot\n" + domains[0] + domains[1] + "\n"
        + ">mut\n" + seqs[5][:30] + "W" + seqs[5][31:] + "\n",
        "genes.fasta": "".join(
            f">g{i}\n" + "".join(qrng.choice(list("acgt"), size=20))
            + "atg" + encode_protein(seqs[(7 * i) % 60][:50]) + "taa\n"
            for i in range(6)),
        "reads.fq": "".join(
            f"@r{i}\n{d}\n+\n{'I' * len(d)}\n" for i, d in enumerate(
                "taa" + encode_protein("MV" + seqs[(5 * i) % 60][3:40] + "LM")
                + "taa" for i in range(12))),
    }
    for fn, text in files.items():
        (tmp / fn).write_text(text)
    return {"g": str(tmp / "gdb"), "s": str(tmp / "sdb"), "seqs": seqs,
            "domains": domains,
            "files": {fn: str(tmp / fn) for fn in files}}


@pytest.fixture(scope="module")
def engines(shards):
    """Port engines on a 2x4 grid over both layouts, the port's and the
    JAX package's single-device engines, and JAX's ShardedSearchEngine on
    global_mesh(4) (2x4 of the 8 virtual devices)."""
    g, s = load_db(shards["g"]), load_db(shards["s"])
    return {
        "global": ShardedSearchEngine(g, _grid("2x4")),
        "shard-built": ShardedSearchEngine(s, _grid("2x4")),
        "single": SearchEngine(g, "cpu"),
        "jax single": JaxEngine(jax_load_db(shards["g"])),
        "jax sharded": jax_dist.ShardedSearchEngine(
            jax_load_db(shards["g"]), mesh=jax_dist.global_mesh(4)),
    }


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_index_equals_jax(shards, n_shards):
    got = mesh.shard_index(load_db(shards["g"]), n_shards)
    want = jax_mesh.shard_index(jax_load_db(shards["g"]), n_shards)
    assert got.hash_log2 == want.hash_log2 and got.n_shards == n_shards
    np.testing.assert_array_equal(got.tables, want.tables)
    np.testing.assert_array_equal(got.postings, want.postings)
    assert got.postings_sizes == want.postings_sizes
    for a, b in zip(got.set_offsets, want.set_offsets):
        np.testing.assert_array_equal(a, b)


def _batch(shards, n_rows):
    """A wire batch of the domain-skewed queries (hot sets included),
    padded with empty rows to n_rows."""
    seqs = shards["seqs"][:n_rows - 3] + [
        shards["domains"][0] + shards["domains"][1],
        shards["domains"][2] * 2, shards["seqs"][5][:20]]
    seqs += [""] * (n_rows - len(seqs))
    sizes = [max(len(q) - 6, 0) for q in seqs]
    L = engine_mod._next_pow2(max(max(sizes), 8))
    width = L + 6
    wire = codec.pack_codes7(codec.pad_codes_batch(seqs, width))
    return wire, np.asarray(sizes, np.int64), width


@pytest.fixture(scope="module")
def grid_engines(shards):
    """name -> (port engine, JAX engine) on the same-shaped grids."""
    out = {}
    for name in ("1x4", "2x2"):
        out[name] = (ShardedSearchEngine(load_db(shards["g"]), _grid(name)),
                     jax_dist.ShardedSearchEngine(jax_load_db(shards["g"]),
                                                  mesh=_jax_mesh(name)))
    return out


@pytest.mark.parametrize("grid", ["1x4", "2x2"])
def test_sharded_totals_equal_jax(shards, grid_engines, grid):
    port, jeng = grid_engines[grid]
    assert port.hot_starts is not None
    wire, n, width = _batch(shards, 32)
    want = jax_mesh.make_sharded_totals(
        jeng.mesh, jeng.sharded.hash_log2, jeng.miss_start, width=width)(
        jeng.tables, jeng.hot_thresh, jnp.asarray(wire),
        jnp.asarray(n.astype(np.int32)))
    codes, n_k = port._upload_rows(wire, n)
    got = mesh.sharded_totals(port.tables, port.hot_thresh_np, codes, n_k,
                              hash_log2=port.sharded.hash_log2,
                              miss_start=port.miss_start, width=width)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(np.asarray(want[2]).max()) > 0  # hot runs on some shard


@pytest.mark.parametrize("grid,hot,positions,replicate,pack", [
    ("1x4", False, False, False, True),
    ("1x4", False, True, False, False),
    ("1x4", True, False, False, True),
    ("1x4", True, True, True, False),
    ("2x2", False, True, True, True),
    ("2x2", True, True, False, True),
    ("2x2", True, False, True, False),
])
def test_sharded_group_equals_jax(shards, grid_engines, grid, hot,
                                  positions, replicate, pack):
    """make_sharded_group's outputs, row for row: counts, hit rows and
    packed position bitmaps.  pack: the JAX step's single-key sort packing
    on or off (the port's int64 keys rank the same either way)."""
    port, jeng = grid_engines[grid]
    wire, n, width = _batch(shards, 32)
    cap, k = 512, 16
    bits = max(int(width - 6).bit_length(), 1) if pack else 0
    fn = jax_mesh.make_sharded_group(
        jeng.mesh, jeng.sharded.hash_log2, cap=cap, k=k, width=width,
        positions=positions, hot=hot, pack_w_bits=bits,
        replicate_out=replicate)
    hot_args = ((jeng.hot_thresh, jeng.M, jeng.MT, jeng.hot_starts)
                if hot else ())
    want = [np.asarray(o) for o in fn(jeng.tables, jeng.postings, *hot_args,
                                      jnp.asarray(wire),
                                      jnp.asarray(n.astype(np.int32)))]
    codes, n_k = port._upload_rows(wire, n)
    got = mesh.sharded_group(
        port.tables, port.postings, codes, n_k,
        hash_log2=port.sharded.hash_log2, cap=cap, k=k, width=width,
        positions=positions, hot=port._hot_args() if hot else None,
        replicate_out=replicate)
    assert len(got) == len(want) == (3 if positions else 2)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy().astype(np.uint32), want[1])
    if positions:
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        assert want[2].any()
    assert (want[0][:, 0] > 0).sum() > 20


RUNS = {
    "protein tsv": dict(SequenceType=PROTEIN, File="q.fasta",
                        OutFormat="tsv", Annotations=True, MaxResults=5),
    "protein json positions": dict(SequenceType=PROTEIN, File="q.fasta",
                                   OutFormat="json", ExtractPositions=True,
                                   MaxResults=5),
    "protein aln": dict(SequenceType=PROTEIN, File="q.fasta",
                        OutFormat="tsv", Align=True, MaxResults=3),
    "nucleotide": dict(SequenceType=NUCLEOTIDE, File="genes.fasta",
                       OutFormat="tsv", ExtractPositions=True, MaxResults=5),
    "fastq": dict(SequenceType=READS, File="reads.fq", OutFormat="tsv",
                  MaxResults=3),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_run_search_bytes_equal(shards, engines, run, monkeypatch):
    """The port's ShardedSearchEngine over both artifact layouts, the JAX
    package's ShardedSearchEngine(global_mesh(4)) and the port's
    SearchEngine stream the same bytes."""
    monkeypatch.setattr(swalign_pallas, "sw_batch_dispatch", functools.partial(
        swalign_pallas.sw_batch_dispatch, interpret=True))
    kw = dict(RUNS[run], File=shards["files"][RUNS[run]["File"]])
    want = b"".join(jax_run_search(engines["jax sharded"], JaxOptions(**kw)))
    assert len(re.findall(rb"\bS\d+\b", want)) > 3  # subject ids
    for name in ("single", "global", "shard-built"):
        got = b"".join(run_search(engines[name], SearchOptions(**kw)))
        assert got == want, name


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("layout", ["global", "shard-built"])
def test_positions_gate_bytes_equal(shards, engines, layout, gate,
                                    monkeypatch):
    """Position bitmaps from the device (gate on) or the host binary
    search (gate off) give the single-device engine's bytes."""
    monkeypatch.setattr(engine_mod, "_positions_on_device",
                        lambda *a: gate)
    opts = SearchOptions(**dict(RUNS["protein json positions"],
                                File=shards["files"]["q.fasta"]))
    want = b"".join(run_search(engines["single"], opts))
    eng = engines[layout]
    got = eng.count_batch(shards["seqs"][:4], [len(q) - 6 for q in
                                               shards["seqs"][:4]],
                          k=8, positions=True)
    assert all((qc._bitmaps is not None) == gate for qc in got)
    assert b"".join(run_search(eng, opts)) == want


@pytest.mark.parametrize("layout", ["global", "shard-built"])
def test_host_fallback_past_cap_max(shards, engines, layout):
    """Queries whose shard-local volume exceeds CAP_MAX take the exact
    host bincount (and host bitmaps): the JAX single-device counts."""
    seqs, domains = shards["seqs"], shards["domains"]
    queries = [seqs[2], domains[0] + domains[1], seqs[30][:60]]
    sizes = [len(q) - 6 for q in queries]
    want = engines["jax single"].count_batch(queries, sizes, k=8)
    single = engines["single"]
    want_qc = single.count_batch(queries, sizes, k=8)
    eng = engines[layout]
    eng.CAP_MAX = eng.CAP_MIN = 2  # instance overrides
    try:
        got = eng.count_batch(queries, sizes, k=8)
    finally:
        del eng.CAP_MAX, eng.CAP_MIN
    # the hot query's cold volume may stay under 2: on the device
    assert sum(qg._offs is not None for qg in got) >= 2  # host counts
    for qw, qp, qg in zip(want, want_qc, got):
        np.testing.assert_array_equal(qg.hit_rows, qw.hit_rows)
        np.testing.assert_array_equal(qg.counts, qw.counts)
        rows = [int(r) for r in qw.hit_rows[:4]]
        a = eng.position_bitmaps_np(qg, rows)
        b = single.position_bitmaps_np(qp, rows)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[r], b[r]) for r in rows)


def test_split_sets_balance_cold_expansion(tmp_path):
    """The twin of test_dist.py's: long sets split across all 8 shards
    keep the per-query cold expansion balance tsum/(n*tmax) >= 0.5 on the
    4000-protein skewed database, the per-query SUM equals the
    single-device deduplicated volume, and the port's phase-1 totals
    equal the JAX engine's."""
    path = str(tmp_path / "baldb")
    art = data.ensure_db(path, data.build_skewed_db, 4000, 77)
    rng = np.random.default_rng(5)
    queries = [art.sequence(int(r))[:256]
               for r in rng.integers(0, art.num_proteins, size=64)]
    sizes = [len(q) - 6 for q in queries]

    single = SearchEngine(art, "cpu", hot=False)
    outs1 = single.dispatch_batch(queries, sizes, k=8)[0]
    single_totals = (outs1[7] + outs1[6].sum(dim=1)).numpy()

    eng = ShardedSearchEngine(art, [["cpu"] * 8], hot=False)
    tmax, tsum, _ = (t.numpy()[:64] for t in
                     eng.dispatch_batch(queries, sizes, k=8)[0])
    jeng = jax_dist.ShardedSearchEngine(jax_load_db(path),
                                        mesh=jax_dist.global_mesh(8),
                                        hot=False)
    jt = jeng.dispatch_batch(queries, sizes, k=8)[0]
    np.testing.assert_array_equal(tmax, np.asarray(jt[0])[:64])
    np.testing.assert_array_equal(tsum, np.asarray(jt[1])[:64])
    np.testing.assert_array_equal(tsum, single_totals)
    nz = single_totals > 0
    balance = (tsum[nz] / (8 * np.maximum(tmax[nz], 1))).mean()
    assert balance >= 0.5, f"8-shard cold expansion balance {balance:.3f}"


def test_shard_built_layout_and_guards(shards):
    """The shard-built artifact holds exactly shard_index's arrays of the
    global one; the single-device engine refuses it, and so does a mesh
    whose shard axis differs."""
    g, s = load_db(shards["g"]), load_db(shards["s"])
    assert s.index_shards == 4 and s.postings is None
    ref = mesh.shard_index(g, 4)
    for i in range(4):
        np.testing.assert_array_equal(
            ref.postings[i, : ref.postings_sizes[i]], s.shard_postings[i])
        np.testing.assert_array_equal(ref.set_offsets[i],
                                      s.shard_set_offsets[i])
    with pytest.raises(ValueError, match="index shards"):
        SearchEngine(s, "cpu")
    with pytest.raises(ValueError, match="must match"):
        ShardedSearchEngine(s, _grid("2x2"))


def test_mesh_shapes_and_missing_cards():
    m = global_mesh(4, ["cpu"] * 8)
    assert m.shape == {"dp": 2, "shard": 4}
    assert global_mesh(3, ["cpu"] * 4).shape == {"dp": 2, "shard": 2}
    assert Mesh([["cpu", "cpu"]]).shape == {"dp": 1, "shard": 2}
    with pytest.raises(RuntimeError, match="cuda"):
        Mesh([["cuda:0", "cuda:0"]])
    with pytest.raises(ValueError, match="rectangular"):
        Mesh([["cpu", "cpu"], ["cpu"]])


def test_dryrun_multichip_twin():
    dryrun_multichip(device_grid(2, 4, ["cpu"]))


def test_server_serves_sharded(shards, engines, capsys):
    """serve's engine (load_engine) with n_shards=2 on the CPU answers a
    protein POST with the single-device bytes; a shard-built artifact is
    served sharded without the flag."""
    opts = SearchOptions(**dict(RUNS["protein tsv"],
                                File=shards["files"]["q.fasta"]))
    want = b"".join(run_search(engines["single"], opts))
    with open(shards["files"]["q.fasta"]) as f:
        query = f.read()
    fields = {"type": "string", "sequence": query, "max-results": "5",
              "annotations": "true"}
    eng = app.load_engine(shards["g"], "cpu", n_shards=2)
    assert isinstance(eng, ShardedSearchEngine) and eng.n_shards == 2
    assert "[sharded x2]" in capsys.readouterr().out
    with Served(eng) as url:
        status, body, _ = post(url + "protein", fields)
    assert status == 200 and body == want

    eng = app.load_engine(shards["s"], "cpu")
    assert isinstance(eng, ShardedSearchEngine) and eng.n_shards == 4
    assert "shard-built index: serving sharded x4" in capsys.readouterr().out
    with Served(eng) as url:
        status, body, _ = post(url + "protein", fields)
    assert status == 200 and body == want


@pytest.mark.parametrize("program", ["-server", "-make"])
def test_cli_shards_flag(monkeypatch, program):
    seen = {}
    monkeypatch.setattr(app, "serve",
                        lambda *a, **kw: seen.update(kw, args=a))
    import kaamer_tpu_torch.index.build as build

    monkeypatch.setattr(build, "build_db",
                        lambda *a, **kw: seen.update(kw, args=a))
    argv = ["db", program, "-d", "db", "-shards", "4"]
    if program == "-make":
        argv += ["-i", "in.fasta", "-f", "fasta"]
    assert cli.main(argv) == 0
    assert seen["n_shards"] == 4
    assert cli._db_parser().parse_args([program]).shards == 0
