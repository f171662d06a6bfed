"""The port's bench layer against the root bench.py and __graft_entry__ on
the CPU: the entry twin's search step (exact counts and hit rows), the
random benchmark database (byte-equal artifacts), the bench's inputs
(byte-equal files and query strings for the same seeds), the whole
throughput twin at a cut size in a subprocess, the CPU stand-in
baseline, and the bin/ launchers."""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench
from kaamer_tpu_torch.bench import cpu_baseline, data, entry, throughput

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "kaamer_tpu", "bench")
AA = "ACDEFGHIKLMNPQRSTVWY"
# the throughput twin's cut: the headline DB and the per-section counts
CUT_PROTEINS = 2000
CUT_ARGS = ["--device", "cpu", "--db-proteins", str(CUT_PROTEINS),
            "--queries", "64", "--reads", "128", "--aln-queries", "32",
            "--pairs", "16"]
EXTRA_KEYS = {"baseline_note", "cpu_baseline_qps", "cpu_baseline_1m_qps",
              "vs_baseline_1m", "skewed_db", "random_db_qps_10k",
              "fastq_reads_per_s", "aligned_pairs_per_s", "align_on_device",
              "aln_queries_per_s", "skipped_dbs", "batch", "query_len",
              "card"}


def _env(cache):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["KAAMER_BENCH_CACHE"] = str(cache)
    return env


def _jax_step(n_proteins, queries):
    """__graft_entry__.entry's search step on its _synthetic_index of
    n_proteins with these query strings, one row each."""
    import jax.numpy as jnp

    from kaamer_tpu.search.engine import _phase1_impl, _phase2_grouped_impl

    ht, set_offsets, postings, _ = graft._synthetic_index(n_proteins)
    pad = (-len(postings)) % 128
    postings = np.concatenate([postings, np.zeros(pad, postings.dtype)])
    codes, n_kmers = graft._query_arrays(queries, len(queries), entry.L)
    outs = _phase1_impl(jnp.asarray(ht.table), jnp.asarray(codes),
                        jnp.asarray(n_kmers), hash_log2=ht.log2,
                        miss_start=int(set_offsets[-1]))
    return _phase2_grouped_impl(
        jnp.asarray(postings), outs[0], outs[1], outs[2], outs[3], outs[5],
        outs[6], cap_s=entry.CAP, cap_t=entry.CAP_T, k=entry.K)


def _chimeras(seqs, rng, n):
    """n queries, each the first half of one indexed protein and the second
    half of another, with 0-3 point mutations: two hits or more a query."""
    out = []
    for _ in range(n):
        a, b = rng.choice(len(seqs), size=2, replace=False)
        h = len(seqs[a]) // 2
        s = list(seqs[a][:h] + seqs[b][h:])
        for _ in range(int(rng.integers(0, 4))):
            s[int(rng.integers(0, len(s)))] = AA[int(rng.integers(0, 20))]
        out.append("".join(s))
    return out


def test_entry_equals_graft_entry():
    """entry("cpu") on __graft_entry__.entry()'s index and queries: the
    same index arrays, counts and hit rows (JAX's uint32 rows as int64)."""
    step, args = graft.entry()
    want_counts, want_rows = (np.asarray(x) for x in step(*args))
    got_step, got_args = entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in got_args)
    np.testing.assert_array_equal(
        got_args[0].numpy().view(np.uint32), np.asarray(args[0]))
    np.testing.assert_array_equal(
        got_args[1].numpy().view(np.uint32), np.asarray(args[1]))
    counts, rows = got_step(*got_args)
    assert counts.dtype == torch.int32 and rows.dtype == torch.int64
    assert counts.shape == (entry.B, entry.K)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(rows.numpy(),
                                  want_rows.astype(np.int64))


def test_entry_mutated_queries_on_a_larger_index():
    """A 256-protein index and 16 mutated chimeric queries (each hits two
    proteins or more): counts and hit rows equal the JAX step's."""
    seqs = entry._synthetic_index(256)[3]
    queries = _chimeras(seqs, np.random.default_rng(11), entry.B)
    want_counts, want_rows = (np.asarray(x)
                              for x in _jax_step(256, queries))
    step, args = entry.entry("cpu", n_proteins=256, queries=queries)
    counts, rows = step(*args)
    assert ((want_counts > 0).sum(axis=1) >= 2).all()
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(rows.numpy(), want_rows.astype(np.int64))


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()


def test_build_synthetic_db_bytes_equal_bench(tmp_path):
    """data.build_synthetic_db writes bench.build_synthetic_db's artifact,
    file for file."""
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
    bench.build_synthetic_db(str(tmp_path / "a" / "rand"), 500)
    data.build_synthetic_db(str(tmp_path / "b" / "rand"), 500)
    a, b = tmp_path / "a" / "rand", tmp_path / "b" / "rand"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "hash_table.npy" in names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    assert (data.DB_PROTEINS, data.BATCH, data.SEQ_LEN_RANGE) == (
        bench.DB_PROTEINS, bench.BATCH, bench.SEQ_LEN_RANGE)


class _Hit:
    Length = 1


class _Counts:
    hit_rows = np.array([0], np.uint32)


class _StubEngine:
    """Records count_batch's queries; every query hits row 0."""
    device = torch.device("cpu")

    def __init__(self):
        self.seen = []

    def count_batch(self, seqs, sizes, k, positions=False):
        self.seen.append((list(seqs), list(sizes), k))
        return [_Counts() for _ in seqs]


def _recording_run_search(files, n_chunks):
    def run_search(engine, opts, cancel=None):
        with open(opts.File) as f:
            files.append((os.path.basename(opts.File), f.read(),
                          opts.SequenceType, opts.Align, opts.MaxResults))
        for _ in range(n_chunks):
            yield b"hit\n"
    return run_search


def test_bench_inputs_equal_bench(tmp_path, monkeypatch):
    """One seed-7 generator through bench_fastq, bench_align and
    bench_align_e2e, in bench.py's order and the twin's: the same reads
    and warm files, the same -aln query file, the same align_batch query
    strings (run_search, count_batch and align_batch stubbed), and the
    generators end in the same state."""
    import kaamer_tpu.ops.swalign as jsw
    import kaamer_tpu.search.pipeline as jpipe
    import kaamer_tpu_torch.ops.swalign as tsw
    import kaamer_tpu_torch.search.pipeline as tpipe

    art = data.ensure_db(str(tmp_path / "skew"), data.build_skewed_db, 300)
    got = {}
    for side, pipe, sw, mod in (("bench", jpipe, jsw, bench),
                                ("twin", tpipe, tsw, throughput)):
        files, eng = [], _StubEngine()
        monkeypatch.setattr(pipe, "run_search",
                            _recording_run_search(files, 8192))
        monkeypatch.setattr(sw, "align_batch",
                            lambda pairs, *a, **kw: [_Hit()] * len(pairs))
        rng = np.random.default_rng(7)
        td = tmp_path / side
        os.makedirs(td)
        mod.bench_fastq(eng, art, rng, str(td))
        mod.bench_align(eng, art, rng)
        mod.bench_align_e2e(eng, art, rng, str(td))
        got[side] = (files, eng.seen, rng.integers(0, 2**62, size=4))
    (jf, jseen, jrest), (tf, tseen, trest) = got["bench"], got["twin"]
    assert [f[0] for f in tf] == ["warm.fq", "bench_reads.fq",
                                  "bench_reads.fq", "bench_aln.fasta",
                                  "bench_aln.fasta", "bench_aln.fasta"]
    assert tf == jf
    assert tf[1][1].count("\n") == 4 * 8192
    assert tseen == jseen and len(tseen[0][0]) == 256
    np.testing.assert_array_equal(trest, jrest)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The CPU stand-in measured on a 2,000-protein skewed DB in a fresh
    cache (the binary built with g++ on first use)."""
    cache = tmp_path_factory.mktemp("bench_cache")
    proc = subprocess.run(
        [sys.executable, "-m", "kaamer_tpu_torch.bench.cpu_baseline",
         "--proteins", str(CUT_PROTEINS), "--queries", "512", "--threads",
         "2"], cwd=REPO, env=_env(cache), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cache, json.loads(proc.stdout.strip().splitlines()[-1])


def test_cpu_baseline_records_this_host(baseline, monkeypatch):
    cache, rec = baseline
    assert os.path.exists(cpu_baseline.EXE)
    with open(cache / cpu_baseline.RESULT_FILE) as f:
        assert json.load(f) == rec
    # the committed TPU-host baseline stays the only one at the root
    assert sorted(n for n in os.listdir(REPO)
                  if n.startswith("CPU_BASELINE")) == ["CPU_BASELINE_r05.json"]
    head = rec["per_db"][str(CUT_PROTEINS)]
    assert rec["queries_per_s"] == head["queries_per_s"] > 0
    assert head["idealized_queries_per_s"] > 0 and head["n_queries"] == 512
    assert rec["host"] == cpu_baseline.host()
    assert rec["host"]["cores"] == os.cpu_count()
    assert rec["db_proteins"] == CUT_PROTEINS and rec["threads"] == 2

    monkeypatch.setattr(data, "CACHE_ROOT", str(cache))
    assert cpu_baseline.load_for_this_host(CUT_PROTEINS)["queries_per_s"] \
        == rec["queries_per_s"]
    # measured for another headline DB: not a denominator
    assert cpu_baseline.load_for_this_host(data.DB_PROTEINS) is None
    # measured on another host: not a denominator
    other = dict(rec, host=dict(rec["host"], node="another-host"))
    with open(cache / cpu_baseline.RESULT_FILE, "w") as f:
        json.dump(other, f)
    try:
        assert cpu_baseline.load_for_this_host(CUT_PROTEINS) is None
    finally:
        with open(cache / cpu_baseline.RESULT_FILE, "w") as f:
            json.dump(rec, f)


def _run_twin(cache):
    """python -m kaamer_tpu_torch.bench.throughput at the cut, in a fresh
    interpreter; returns (stdout lines, the forbidden modules loaded)."""
    code = ("import json, sys\n"
            "from kaamer_tpu_torch.bench import throughput\n"
            f"rc = throughput.main({CUT_ARGS!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print('LOADED ' + json.dumps(bad), file=sys.stderr)\n"
            "sys.exit(rc)\n")
    env = _env(cache)
    env["KAAMER_BENCH_SIZES"] = str(CUT_PROTEINS)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = [ln for ln in proc.stderr.splitlines()
              if ln.startswith("LOADED ")]
    return proc.stdout.strip().splitlines(), json.loads(loaded[-1][7:])


def test_throughput_twin_prints_one_line(baseline):
    """The whole twin at the cut on the CPU: one JSON line with bench.py's
    keys (less the tunnel probe, plus card), positive rates, vs_baseline
    from this host's baseline, no kernel launch (the CPU runs the plain
    versions) and no jax, kaamer_tpu or bench module loaded."""
    cache, rec = baseline
    lines, loaded = _run_twin(cache)
    assert loaded == []
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    ex = out["extra"]
    assert EXTRA_KEYS <= set(ex) and "tunnel_4mb_roundtrip_s" not in ex
    assert out["unit"] == "queries/s" and "1 card" in out["metric"]
    per = ex["skewed_db"][str(CUT_PROTEINS)]
    assert set(per) == {"qps", "qps_positions", "kmer_lookups_per_s",
                        "n_queries"} and per["n_queries"] == 64
    assert out["value"] == per["qps"] > 0 and per["qps_positions"] > 0
    for key in ("random_db_qps_10k", "fastq_reads_per_s",
                "aligned_pairs_per_s", "aln_queries_per_s"):
        assert ex[key] > 0, key
    assert ex["align_on_device"] is False and ex["card"] is None
    assert ex["sw_align_launches"] == {"bench_align": 0,
                                       "bench_align_e2e": 0}
    assert out["vs_baseline"] == pytest.approx(per["qps"]
                                               / rec["queries_per_s"])
    assert ex["cpu_baseline_qps"] == rec["queries_per_s"]
    assert ex["skipped_dbs"] == [] and ex["vs_baseline_1m"] is None
    assert (ex["batch"], ex["query_len"]) == (2048, 250)


def test_throughput_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        throughput.run("cuda")


@pytest.mark.parametrize("launcher,argv", [
    ("kaamer-db-torch", ["-h"]),
    ("kaamer-torch", ["--help"]),
    ("kaamer-torch", []),
])
def test_launcher_help_exits_0(launcher, argv):
    proc = subprocess.run([os.path.join(REPO, "bin", launcher), *argv],
                          capture_output=True, text=True, timeout=120,
                          env=_env(REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage: kaamer")


def test_launcher_h_is_the_host_flag_as_in_bin_kaamer():
    """kaamer's -h names the server host (the reference's flag), so
    `kaamer-torch -h` fails as `bin/kaamer -h` does, with its message."""
    got, want = (subprocess.run([os.path.join(REPO, "bin", b), "-h"],
                                capture_output=True, text=True, timeout=120)
                 for b in ("kaamer-torch", "kaamer"))
    assert got.returncode == want.returncode == 2
    assert got.stderr == want.stderr
    assert "argument -h: expected one argument" in got.stderr
