"""The port's serving warmup (SearchEngine.warmup, ShardedSearchEngine.warmup
and the server's background warmup) against the JAX package's contract
(tests/test_engine.py:334-410, tests/test_dist.py:246-251), on CPU
tensors, exactly (tolerance 0): a warmup changes no later batch's group
caps, no answer (run_search bytes equal the JAX engine's, hot and cold,
with and without positions) and no engine.stats count, also while a
request runs alongside it; a workload inside the warmed ladder dispatches
only phase-2 shapes that the warmup dispatched; the error policy; and
serve() starting the warmup in a daemon thread before it serves."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.search.options import SearchOptions as JaxOptions
from kaamer_tpu.search.pipeline import run_search as jax_run_search
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.parallel.dist import ShardedSearchEngine
from kaamer_tpu_torch.search import engine as engine_mod
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.search.options import PROTEIN, SearchOptions
from kaamer_tpu_torch.search.pipeline import run_search
from kaamer_tpu_torch.server import app

AA = "ACDEFGHIKLMNPQRSTVWY"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a small warmup grid: every cap of the ladder and both cap_t tiers, at
# widths and lengths a CPU run affords
SMALL = dict(batch_sizes=(16,), lengths=(16, 32), positions=(False, True),
             cap_ts=(0, 32))


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">prot{i} synthetic protein {i}\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60] + "\n")


@pytest.fixture(scope="module")
def heavy_db(tmp_path_factory):
    """tests/test_engine.py's heavy_db: ~400 proteins share a 26-mer."""
    rng = np.random.default_rng(99)
    shared = "".join(rng.choice(list(AA), size=26))
    seqs = []
    for _ in range(400):
        pre = "".join(rng.choice(list(AA), size=int(rng.integers(10, 30))))
        post = "".join(rng.choice(list(AA), size=int(rng.integers(10, 30))))
        seqs.append(pre + shared + post)
    for _ in range(50):
        seqs.append("".join(rng.choice(list(AA), size=60)))
    tmp = tmp_path_factory.mktemp("warm_heavy")
    _write_fasta(str(tmp / "in.fasta"), seqs)
    build_db(str(tmp / "db"), str(tmp / "in.fasta"), "fasta")
    return load_db(str(tmp / "db")), seqs


@pytest.fixture(scope="module")
def skew_db(tmp_path_factory):
    """tests/test_engine.py's skew_db (Zipf-ish shared domains), its
    workload and a query file of it; both packages load the artifact."""
    rng = np.random.default_rng(7)
    domains = ["".join(rng.choice(list(AA), size=int(rng.integers(25, 60))))
               for _ in range(6)]
    seqs = []
    for _ in range(70):
        parts = [dom for d, dom in enumerate(domains)
                 if rng.random() < 1.0 / (d + 2)]
        parts.append("".join(rng.choice(list(AA),
                                        size=int(rng.integers(20, 60)))))
        rng.shuffle(parts)
        seqs.append("".join(parts))
    tmp = tmp_path_factory.mktemp("warm_skew")
    _write_fasta(str(tmp / "in.fasta"), seqs)
    build_db(str(tmp / "db"), str(tmp / "in.fasta"), "fasta")
    # test_warmup_covers_skewed_serving_grid's workload
    qrng = np.random.default_rng(13)
    queries = []
    for i in range(24):
        q = seqs[i % len(seqs)][: int(qrng.integers(20, 70))]
        if len(q) >= 7:
            queries.append(q)
    queries += [domains[0][:38], domains[1][:30] + domains[2][:30]]
    qfile = str(tmp / "q.fasta")
    with open(qfile, "w") as f:
        for i, q in enumerate(queries + [seqs[3], seqs[11],
                                         domains[0] + domains[1]]):
            f.write(f">q{i} warm query\n{q}\n")
    return {"dir": str(tmp / "db"), "art": load_db(str(tmp / "db")),
            "queries": queries, "qfile": qfile}


@pytest.fixture(scope="module")
def shard_db(tmp_path_factory):
    """tests/test_torch_dist.py's database of 300 proteins (every shard of
    2 and of 4 holds hot sets) and its protein query file."""
    rng = np.random.default_rng(31)
    domains = ["".join(rng.choice(list(AA), size=int(rng.integers(25, 50))))
               for _ in range(5)]
    seqs = []
    for _ in range(300):
        parts = [d for j, d in enumerate(domains)
                 if rng.random() < 1.0 / (j + 2)]
        parts.append("".join(rng.choice(list(AA),
                                        size=int(rng.integers(30, 70)))))
        rng.shuffle(parts)
        seqs.append("".join(parts))
    tmp = tmp_path_factory.mktemp("warm_shards")
    _write_fasta(str(tmp / "in.fasta"), seqs)
    build_db(str(tmp / "db"), str(tmp / "in.fasta"), "fasta")
    qfile = str(tmp / "q.fasta")
    with open(qfile, "w") as f:
        f.write("".join(f">q{i}\n{seqs[i]}\n" for i in (0, 9, 33))
                + ">hot\n" + domains[0] + domains[1] + "\n"
                + ">mut\n" + seqs[5][:30] + "W" + seqs[5][31:] + "\n")
    return {"dir": str(tmp / "db"), "art": load_db(str(tmp / "db")),
            "qfile": qfile}


def _bytes(engine, qfile, positions, jax=False):
    opts = (JaxOptions if jax else SearchOptions)(
        File=qfile, SequenceType=PROTEIN,
        OutFormat="json" if positions else "tsv", ExtractPositions=positions)
    return b"".join((jax_run_search if jax else run_search)(engine, opts))


def _record_shapes(monkeypatch, engine):
    """Wrap the phase-2 functions: each call appends (kind, G, L, cap_s,
    cap_t, positions), G being the planned width _dispatch_group got, or
    the rows dispatched where a warmup calls phase 2 directly."""
    shapes, planned = [], [None]
    orig_group = engine._dispatch_group

    def dispatch_group(outs1, rows, G, *a, **kw):
        planned[0] = G
        try:
            return orig_group(outs1, rows, G, *a, **kw)
        finally:
            planned[0] = None

    def wrap(kind, fn):
        def phase2(postings, *a, **kw):
            offs = a[2] if kind == "hot" else a[0]
            shapes.append((kind, planned[0] or offs.shape[0], offs.shape[1],
                           kw["cap_s"], kw["cap_t"], kw["positions"]))
            return fn(postings, *a, **kw)
        return phase2

    monkeypatch.setattr(engine, "_dispatch_group", dispatch_group)
    monkeypatch.setattr(engine_mod, "_phase2_grouped_impl",
                        wrap("cold", engine_mod._phase2_grouped_impl))
    monkeypatch.setattr(engine_mod, "_phase2_hot_impl",
                        wrap("hot", engine_mod._phase2_hot_impl))
    return shapes


def test_warmup_does_not_change_group_caps(heavy_db, monkeypatch):
    """A batch's group caps come from its own totals: a warmup's synthetic
    batches leave a later batch's caps as they were."""
    art, seqs = heavy_db
    engine = SearchEngine(art, "cpu", hot=False)
    orig = engine_mod._phase2_grouped_impl

    def caps_of(queries):
        calls = []

        def counting(*a, **kw):
            calls.append(kw["cap_s"] + 128 * kw["cap_t"])
            return orig(*a, **kw)

        monkeypatch.setattr(engine_mod, "_phase2_grouped_impl", counting)
        engine.count_batch(queries, [len(q) - 6 for q in queries], k=10)
        monkeypatch.setattr(engine_mod, "_phase2_grouped_impl", orig)
        return calls

    before = caps_of([seqs[0]])
    engine.warmup(batch_sizes=(16,), lengths=(16,), positions=(False,))
    after = caps_of([seqs[0]])
    assert before == after and before[0] > 256


@pytest.mark.parametrize("positions", [False, True],
                         ids=["no-positions", "positions"])
@pytest.mark.parametrize("hot", [True, False], ids=["hot", "cold"])
def test_answers_after_warmup_equal_jax(skew_db, hot, positions):
    """run_search bytes of a warmed engine == an unwarmed one's == the JAX
    engine's, on the hot and the cold path, TSV and JSON with positions."""
    warmed = SearchEngine(skew_db["art"], "cpu", hot=hot)
    assert (warmed.hot_starts is not None) == hot
    warmed.warmup(**SMALL)
    got = _bytes(warmed, skew_db["qfile"], positions)
    fresh = _bytes(SearchEngine(skew_db["art"], "cpu", hot=hot),
                   skew_db["qfile"], positions)
    want = _bytes(JaxEngine(jax_load_db(skew_db["dir"]), hot=hot),
                  skew_db["qfile"], positions, jax=True)
    # real hits: TSV rows, or JSON hits
    assert (want.count(b'"Kmatch"') if positions
            else want.count(b"\n")) > 20
    assert got == fresh == want


def test_warmup_covers_skewed_serving_grid(skew_db, monkeypatch):
    """After warmup, a skewed workload whose lengths and caps sit inside the
    warmed grid dispatches only (kind, G, L, cap_s, cap_t, positions)
    phase-2 shapes that the warmup dispatched: the port's counterpart of
    the JAX test's unchanged compile-cache sizes."""
    engine = SearchEngine(skew_db["art"], "cpu")
    assert engine.hot_starts is not None
    shapes = _record_shapes(monkeypatch, engine)
    # cap_ts=(0,): this workload's postings sets are all below T_SPLIT
    engine.warmup(batch_sizes=(16, 32), lengths=(16, 32, 64),
                  positions=(False, True), cap_ts=(0,))
    warmed = set(shapes)
    del shapes[:]
    queries = skew_db["queries"]
    for pos in (False, True):
        for i in range(0, len(queries), 16):
            chunk = queries[i : i + 16]
            engine.count_batch(chunk, [len(q) - 6 for q in chunk], k=10,
                               positions=pos)
    assert {s[0] for s in shapes} == {"cold", "hot"}
    assert {s[5] for s in shapes} == {False, True}
    assert set(shapes) <= warmed, sorted(set(shapes) - warmed)


@pytest.mark.parametrize("alongside", [False, True],
                         ids=["alone", "alongside-a-request"])
def test_warmup_leaves_stats(skew_db, alongside):
    """engine.stats counts only the requests' chunks: unchanged by a
    warmup, also by one that runs in another thread while requests are
    counted."""
    queries = skew_db["queries"]
    sizes = [len(q) - 6 for q in queries]
    probe = SearchEngine(skew_db["art"], "cpu")
    probe.count_batch(queries, sizes, k=10, positions=True)
    per_request = dict(probe.stats)
    assert per_request["hot"] > 0 and per_request["cold"] > 0

    engine = SearchEngine(skew_db["art"], "cpu")
    engine.count_batch(queries, sizes, k=10, positions=True)
    if not alongside:
        engine.warmup(**SMALL)
        assert engine.stats == per_request
        return
    t = threading.Thread(target=engine.warmup, kwargs=SMALL)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t.start()
        n, deadline = 1, time.monotonic() + 120
        while True:
            engine.count_batch(queries, sizes, k=10, positions=True)
            n += 1
            if not t.is_alive() or time.monotonic() > deadline:
                break
        t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive() and n > 2
    assert engine.stats == {k: n * v for k, v in per_request.items()}


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_sharded_warmup_leaves_stats_and_bytes(shard_db, grid):
    """ShardedSearchEngine.warmup on a grid of CPU devices: stats unchanged
    and run_search bytes equal to an unwarmed sharded engine's and to the
    JAX single-device engine's."""
    dp, n = grid
    eng = ShardedSearchEngine(shard_db["art"], [["cpu"] * n] * dp)
    assert eng.hot_starts is not None
    want = _bytes(JaxEngine(jax_load_db(shard_db["dir"])), shard_db["qfile"],
                  True, jax=True)
    assert want.count(b'"Kmatch"') > 20
    assert _bytes(eng, shard_db["qfile"], True) == want
    before = dict(eng.stats)
    assert before["hot"] > 0
    eng.warmup(batch_sizes=(16,), lengths=(16, 32), positions=(False, True))
    assert eng.stats == before
    assert _bytes(eng, shard_db["qfile"], True) == want


def test_serve_starts_warmup_daemon_thread_first(monkeypatch, capsys):
    """serve() starts engine.warmup in a daemon thread, then serves; the
    thread prints one line when the warmup is done."""
    events, ran, threads = [], [], []
    warmed = threading.Event()

    class Engine:
        def warmup(self):
            ran.append((threading.current_thread().daemon,
                        threading.current_thread() is threading.main_thread()))
            warmed.set()

    class Server:
        def serve_forever(self):
            events.append("serve_forever")
            assert warmed.wait(30)
            raise KeyboardInterrupt

        def shutdown(self):
            events.append("shutdown")

    real_thread = threading.Thread

    class Thread(real_thread):
        def start(self):
            events.append(("start", self.daemon))
            threads.append(self)
            super().start()

    engine = Engine()
    monkeypatch.setattr(app, "load_engine", lambda *a, **kw: engine)
    monkeypatch.setattr(app, "make_server", lambda *a, **kw: Server())
    monkeypatch.setattr(app.threading, "Thread", Thread)
    app.serve("unused-db", 0, "cpu")
    threads[0].join(30)
    assert events == [("start", True), "serve_forever", "shutdown"]
    assert ran == [(True, False)]
    assert "serving-shape warmup ended in" in capsys.readouterr().out


@pytest.mark.parametrize("error", ["ValueError", "RuntimeError",
                                   "OutOfMemoryError"])
def test_warmup_error_policy(skew_db, monkeypatch, capsys, error):
    """A shape the engine refuses (ValueError) is skipped with one line and
    the warmup goes on; an out-of-memory error stops it with one line;
    any other exception (a CUDA error is a RuntimeError) propagates."""
    engine = SearchEngine(skew_db["art"], "cpu", hot=False)
    orig = engine_mod._phase2_grouped_impl
    calls = []

    def failing(*a, **kw):
        calls.append(kw["cap_s"])
        if kw["cap_s"] == 96:
            raise {"ValueError": ValueError("refused shape"),
                   "RuntimeError": RuntimeError("CUDA error: unspecified "
                                                "launch failure"),
                   "OutOfMemoryError": torch.cuda.OutOfMemoryError(
                       "CUDA out of memory. Tried to allocate\n...")}[error]
        return orig(*a, **kw)

    monkeypatch.setattr(engine_mod, "_phase2_grouped_impl", failing)
    grid = dict(batch_sizes=(16,), lengths=(16,), positions=(False, True),
                cap_ts=(0,))
    if error == "RuntimeError":
        with pytest.raises(RuntimeError, match="launch failure"):
            engine.warmup(**grid)
        assert calls[-1] == 96
        return
    engine.warmup(**grid)
    err = capsys.readouterr().err.splitlines()
    if error == "ValueError":
        # both positions' G=16 shape at cap 96 skipped, the ladder goes on
        assert err == [f"warmup: skipped phase 2 cold G=16 L=16 cap=96 "
                       f"cap_t=0 positions={p}: refused shape"
                       for p in (False, True)]
        assert calls.count(96) == 2 and calls[-1] == 512
    else:
        assert err == ["warmup: stopped at phase 2 cold G=16 L=16 cap=96 "
                       "cap_t=0 positions=False: out of memory: CUDA out of "
                       "memory. Tried to allocate"]
        assert calls[-1] == 96 and calls.count(96) == 1


def test_warmup_imports_no_jax(tmp_path):
    """A fresh interpreter builds a database with the port, warms both
    engines on it and loads no jax or kaamer_tpu module."""
    code = f"""
import sys
import numpy as np
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.index.build import build_db
from kaamer_tpu_torch.parallel.dist import ShardedSearchEngine
from kaamer_tpu_torch.search.engine import SearchEngine
rng = np.random.default_rng(5)
dom = "".join(rng.choice(list({AA!r}), size=40))
with open({str(tmp_path / 'in.fasta')!r}, "w") as f:
    for i in range(120):
        tail = "".join(rng.choice(list({AA!r}), size=30))
        f.write(f">p{{i}} x\\n{{dom if i % 2 else ''}}{{tail}}\\n")
build_db({str(tmp_path / 'db')!r}, {str(tmp_path / 'in.fasta')!r}, "fasta")
art = load_db({str(tmp_path / 'db')!r})
SearchEngine(art, "cpu").warmup(batch_sizes=(16,), lengths=(16,),
                                cap_ts=(0,))
ShardedSearchEngine(art, [["cpu"] * 2]).warmup(batch_sizes=(16,),
                                               lengths=(16,))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kaamer_tpu", "bench"))
assert not bad, bad
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
