"""Phase-2 chunks as replayed CUDA graphs (kaamer_tpu_torch/search/graphs.py).

On the CPU: a chunk padded with null rows gives each real row the bytes
of the unpadded chunk, in all three phase-2 functions; the key and the
second-sighting rule with the capture stubbed; the engine's graph path
end to end with stand-in graphs that run the chunk's function in two
parts around the hot-set GEMM, as a capture splits it; hot_matmul's
out=.  On a card (skipped without one; no jax, so on the card run them
with `python -m pytest tests/test_torch_graphs.py -q --noconftest`):
replays byte-equal to eager chunks, two request threads during
captures, and the rle_sorted launch count with and without graphs.
Exact equality throughout: counts and rows are integers."""

import threading

import numpy as np
import pytest
import torch

from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.index.build import build_db
from kaamer_tpu_torch.ops import hotset
from kaamer_tpu_torch.search import engine as te
from kaamer_tpu_torch.search import graphs
from kaamer_tpu_torch.search.engine import SearchEngine

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def skew(tmp_path_factory):
    """Proteins of 1-3 power-law-popular domains with random linkers
    (long shared postings sets, so hot sets and tile runs), and queries:
    mutated proteins, proteins joined to 300-420 residues (past 256
    k-mers), and proteins repeated to 120 residues (wide plateaus that a
    starved TAM cold list cannot certify)."""
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("torch_graphs")
    doms = ["".join(rng.choice(list(AA), size=int(rng.integers(20, 45))))
            for _ in range(12)]
    pop = 1.0 / (np.arange(12) + 2.0)
    pop /= pop.sum()
    seqs = []
    with open(tmp / "db.fasta", "w") as f:
        for i in range(250):
            parts = []
            for _ in range(int(rng.integers(1, 4))):
                parts.append("".join(rng.choice(
                    list(AA), size=int(rng.integers(5, 15)))))
                parts.append(doms[int(rng.choice(12, p=pop))])
            seqs.append("".join(parts))
            f.write(f">G{i:05d} graph test {i}\n{seqs[-1]}\n")
    build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")

    def mutate(s):
        s = list(s)
        for _ in range(int(rng.integers(0, 5))):
            s[int(rng.integers(0, len(s)))] = AA[int(rng.integers(0, 20))]
        return "".join(s)

    pick = lambda: seqs[int(rng.integers(0, len(seqs)))]  # noqa: E731
    short = [mutate(pick()) for _ in range(40)]
    long_ = []
    while len(long_) < 24:
        q = "".join(pick() for _ in range(8))
        if len(q) >= 300:
            long_.append(mutate(q[:420]))
    plateau = [(pick() * 4)[:120] for _ in range(40)]
    return load_db(str(tmp / "db")), short, long_, plateau


def _sizes(queries):
    return [len(q) - 6 for q in queries]


def _chunk_inputs(engine, queries, rows):
    """The batch's phase-1 outputs, its stacked tables, and the tier caps
    of a chunk over rows."""
    outs1 = engine.dispatch_batch(queries, _sizes(queries), k=10)[0]
    ts_l, tt_l = outs1[7].tolist(), outs1[8].tolist()
    cap_s, cap_t = te._tier_caps(rows, False, ts_l, tt_l)
    return outs1, te._StackedRows(outs1, engine.miss_start), cap_s, cap_t


def _phase2(engine, kind, x, cap_s, cap_t, L):
    """The chunk's function on the six tables x (offs, cum_s, wstart,
    whot, cum_t, lens_l)."""
    tiers = dict(cap_s=cap_s, cap_t=cap_t, k=16)
    if kind == "cold":
        return te._phase2_grouped_impl(engine.postings, x[0], x[1], x[2],
                                       x[4], x[5], **tiers)
    if kind == "hot":
        return te._phase2_hot_impl(
            engine.postings, engine.M, engine.hot_starts, *x,
            pack_w_bits=engine._pack_w_bits(L), k_cold=engine._k_cold,
            **tiers)
    return te._phase2_hot_legacy_impl(engine.postings, engine.M,
                                      engine.hot_starts, *x, **tiers)


@pytest.mark.parametrize("kind", ["cold", "hot", "legacy"])
@pytest.mark.parametrize("which,n,G_pad", [("short", 5, 16),
                                           ("short", 16, 32),
                                           ("long", 11, 16)])
def test_null_rows_leave_real_rows(skew, kind, which, n, G_pad):
    """Rows padded with the null row (slice start miss_start, wstart 1,
    zeros elsewhere): the real rows' outputs of each phase-2 function,
    certificate included, are those of the unpadded chunk, and the null
    row's counts are all 0."""
    art, short, long_, _ = skew
    queries = short if which == "short" else long_
    engine = SearchEngine(art, "cpu")
    assert engine.hot_starts is not None
    rows = list(range(2, 2 + n))
    outs1, stacked, cap_s, cap_t = _chunk_inputs(engine, queries, rows)
    L = outs1[0].shape[1]
    assert (L > 256) == (which == "long")
    B = len(queries)
    idx = torch.tensor(rows + [B] * (G_pad - n))
    padded = _phase2(engine, kind, stacked.get().index_select(1, idx),
                     cap_s, cap_t, L)
    ridx = torch.tensor(rows)
    tables = [outs1[i].index_select(0, ridx) for i in (0, 1, 2, 4, 5, 6)]
    eager = _phase2(engine, kind, tables, cap_s, cap_t, L)
    assert len(padded) == len(eager) == (3 if kind == "hot" else 2)
    for p, e in zip(padded, eager):
        assert p.shape[0] == G_pad and p.dtype == e.dtype
        assert torch.equal(p[:n], e)
    assert int(padded[0][n:].abs().sum()) == 0
    assert bool(padded[0][:n].gt(0).any())


def test_pad_width_and_key():
    """G_pad: the rows' next power of two, at least 16, at most the
    planned width (a heavy re-run chunk planned at 4 stays at 4)."""
    assert [graphs.pad_width(G, n) for G, n in (
        (4, 3), (16, 1), (16, 16), (64, 17), (64, 64), (256, 100),
        (2048, 5), (2048, 1025), (1024, 513))] == [
        4, 16, 16, 32, 64, 128, 16, 2048, 1024]
    assert graphs.graph_key("hot", 256, 100, 512, 320, 32, 16, 10, 64) == (
        "hot", 128, 512, 320, 32, 16, 10, 64)
    assert graphs.graph_key("cold", 64, 20, 128, 80, 0, 16) == (
        "cold", 32, 128, 80, 0, 16, 0, 0)


class _Fake:
    """A stand-in graph whose replay counts itself."""

    def __init__(self, log):
        self.log = log

    def replay(self):
        self.log.append("replay")


def _stub_capture(monkeypatch, log, fail=()):
    def capture(self, key, phase2, gemm):
        log.append(("capture", key))
        if key in fail:
            return None
        ch = graphs._Captured()
        ch.graphs = [_Fake(log)] * (1 if gemm is None else 2)
        ch.inputs = torch.zeros((6, key[1], key[2]), dtype=torch.int64)
        ch.outs = (torch.arange(key[1]), torch.arange(key[1]) * 2)
        ch.W = ch.gemm_out = None
        ch.rle = 3
        return ch
    monkeypatch.setattr(graphs.ChunkGraphs, "_capture", capture)


def test_second_sighting_rule(monkeypatch):
    """A key's first chunk runs eagerly (None), its second captures and
    replays, later ones replay only; a failed capture leaves the key
    eager for good without trying again; every replay counts the
    rle_sorted launches recorded at its capture; at MAX_KEYS captured
    keys a new key runs eagerly."""
    from kaamer_tpu_torch.ops import count

    log = []
    _stub_capture(monkeypatch, log, fail={("cold", 32, 64, 80, 0, 16, 0, 0)})
    cg = graphs.ChunkGraphs("cpu", 0)
    stats = dict.fromkeys(("graph_keys", "graph_captures",
                           "graph_replays"), 0)
    filled = []
    run = lambda key, n: cg.run(key, n, filled.append,  # noqa: E731
                                lambda x, g: None, stats)
    a = graphs.graph_key("cold", 64, 20, 128, 80, 0, 16)
    b = graphs.graph_key("cold", 64, 20, 64, 80, 0, 16)
    n0 = count.thread_launches()
    assert run(a, 20) is None and log == [] and filled == []
    assert stats == {"graph_keys": 1, "graph_captures": 0,
                     "graph_replays": 0}
    out = run(a, 20)
    assert log == [("capture", a), "replay"] and len(filled) == 1
    assert [t.tolist() for t in out] == [list(range(20)),
                                         list(range(0, 40, 2))]
    assert count.thread_launches() == n0 + 3
    out = run(a, 7)
    assert log[2:] == ["replay"] and [len(t) for t in out] == [7, 7]
    assert count.thread_launches() == n0 + 6
    assert stats == {"graph_keys": 1, "graph_captures": 1,
                     "graph_replays": 2}
    assert run(b, 20) is None and run(b, 20) is None and run(b, 20) is None
    assert log[3:] == [("capture", b)]
    assert stats["graph_keys"] == 2 and stats["graph_captures"] == 1
    monkeypatch.setattr(graphs, "MAX_KEYS", 2)
    c = graphs.graph_key("hot", 16, 3, 64, 64, 0, 16, 8, 64)
    assert run(c, 3) is None and run(c, 3) is None
    assert log[4:] == [] and stats["graph_keys"] == 3
    assert run(a, 20) is not None


class _Stop(Exception):
    pass


class _Part:
    def __init__(self, fn):
        self.replay = fn


def _cpu_graphs(monkeypatch, engine):
    """The engine's graph path on the CPU, each capture replaced by
    stand-in graphs: A runs the chunk's function up to the GEMM's operand
    W and stops there; B runs it again from the GEMM's output, which
    ChunkGraphs.run wrote between the two, as a captured pair does."""
    def capture(self, key, phase2, gemm):
        G, L = key[1], key[2]
        ch = graphs._Captured()
        ch.inputs = torch.empty((6, G, L), dtype=torch.int64)
        ch.W, ch.outs, ch.rle = None, None, 0
        if gemm is None:
            ch.gemm_out = None

            def whole():
                ch.outs = phase2(ch.inputs, None)
            ch.graphs = [_Part(whole)]
            return ch
        ch.gemm_out = torch.empty((G, gemm.P), dtype=gemm.dtype)

        def a():
            def stop(W, M, L):
                ch.W = W
                raise _Stop
            with pytest.raises(_Stop):
                phase2(ch.inputs, stop)

        def b():
            ch.outs = phase2(ch.inputs, lambda W, M, L: ch.gemm_out)
        ch.graphs = [_Part(a), _Part(b)]
        return ch
    monkeypatch.setattr(graphs.ChunkGraphs, "_capture", capture)
    engine._graphs = graphs.ChunkGraphs("cpu", engine._gemm_bytes())
    return engine


def _answers(engine, batches, positions=False):
    out = []
    for queries in batches:
        for qc in engine.count_batch(queries, _sizes(queries), k=10,
                                     positions=positions):
            out.append((qc.hit_rows.tolist(), qc.counts.tolist(),
                        None if qc._bitmaps is None
                        else qc._bitmaps.tolist()))
    return out


@pytest.mark.parametrize("hot", [True, False])
def test_engine_graph_path_on_cpu(skew, monkeypatch, hot):
    """The engine's graph path with stand-in graphs: every answer equals
    the eager engine's, over batches whose chunk shapes recur (short,
    long and plateau queries, TAM re-runs forced by a one-row cold list);
    chunks of a shape seen twice replay; positions=True batches and a
    warmup take no graph and count nothing."""
    art, short, long_, plateau = skew
    batches = [short[:24], long_[:12], plateau[:24], short[16:], long_[12:],
               plateau[16:], short[:24], plateau[:24]]
    eager = SearchEngine(art, "cpu", hot=hot)
    engine = _cpu_graphs(monkeypatch, SearchEngine(art, "cpu", hot=hot))
    for e in (eager, engine):
        e._k_cold = 1
    engine.warmup(batch_sizes=(16,), lengths=(16, 32))
    assert engine.stats["graph_keys"] == 0 and not engine._graphs._seen
    assert _answers(engine, batches) == _answers(eager, batches)
    s = engine.stats
    assert s["graph_replays"] > 0 and s["graph_captures"] > 0
    assert s["graph_keys"] + s["graph_replays"] == (
        s["hot"] + s["cold"] + s["legacy"])
    assert s["legacy"] > 0 if hot else s["hot"] == s["legacy"] == 0
    before = dict(s)
    assert (_answers(engine, batches[:3], positions=True)
            == _answers(eager, batches[:3], positions=True))
    assert all(s[k] == before[k] for k in (
        "graph_keys", "graph_captures", "graph_replays"))


@pytest.mark.parametrize("max_w,m_dtype", [(40, torch.float32),
                                           (200, torch.bfloat16),
                                           (600, torch.bfloat16),
                                           (600, torch.float32)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_hot_matmul_out(max_w, m_dtype, out_dtype):
    """hot_matmul(..., out=buf) writes the bytes it returns without out
    into buf and returns buf; an out of another dtype is refused."""
    if out_dtype == torch.bfloat16 and max_w > 256:
        pytest.skip("a bf16 result holds counts up to 256")
    rng = np.random.default_rng(max_w)
    W = torch.from_numpy(rng.integers(0, max_w + 1, (9, 24))
                         .astype(np.float32))
    M = torch.from_numpy((rng.random((24, 300)) < 0.3)
                         .astype(np.float32)).to(m_dtype)
    want = hotset.hot_matmul(W, M, max_w=max_w, out_dtype=out_dtype)
    buf = torch.full((9, 300), -1.0, dtype=out_dtype)
    got = hotset.hot_matmul(W, M, max_w=max_w, out_dtype=out_dtype, out=buf)
    assert got is buf and torch.equal(buf, want)
    other = torch.float32 if out_dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError):
        hotset.hot_matmul(W, M, max_w=max_w, out_dtype=out_dtype,
                          out=torch.empty((9, 300), dtype=other))


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _host(outs):
    return [t.cpu() for t in outs]


@pytest.mark.parametrize("kind", ["cold", "hot", "legacy"])
@pytest.mark.parametrize("which", ["short", "long"])
def test_replays_equal_eager_chunks(skew, cuda, kind, which):
    """One chunk shape four times (pad rows: 5, 11, 13 and 9 rows at
    G_pad 16; cap_t > 0): the first runs eagerly, the second captures
    and replays, the others replay; each result equals the eager
    chunk's over the same rows, on L <= 256 and L > 256 (the float32
    GEMM split)."""
    art, short, long_, _ = skew
    queries = short if which == "short" else long_
    engine = SearchEngine(art, cuda)
    sets = [[0, 1, 2, 3, 4], list(range(6, 17)), list(range(3, 24, 2))[:13],
            [20, 2, 9, 14, 1, 17, 8, 5, 11]]
    hot = kind != "cold"
    legacy = kind == "legacy"
    before = dict(engine.stats)
    for i, rows in enumerate(sets):
        outs1, stacked, cap_s, cap_t = _chunk_inputs(
            engine, queries, sum(sets, []))
        cap_t = max(cap_t, 32)
        L = outs1[0].shape[1]
        args = (outs1, rows, 16, cap_s, cap_t, 16, L, False, hot, legacy)
        got = engine._dispatch_group(*args, stacked=stacked)
        want = engine._dispatch_group(*args)
        assert got[1:] == want[1:]
        for g, w in zip(_host(got[0]), _host(want[0])):
            assert g.dtype == w.dtype and torch.equal(g, w), (i, kind)
    s = {k: v - before[k] for k, v in engine.stats.items()}
    assert (s["graph_keys"], s["graph_captures"], s["graph_replays"]) == (
        1, 1, 3), s
    assert s["rle"] == s["hot"] + s["cold"] + s["legacy"] == 8


def _batches(skew):
    _, short, long_, plateau = skew
    return [short[:24], long_[:12], plateau[:24], short[16:], long_[12:],
            plateau[16:], short[:24], long_[:12], plateau[:24]]


def test_two_threads_during_captures(skew, cuda):
    """Two threads serve batches through one engine while its chunk
    shapes are captured: every answer equals the single-thread eager
    engine's."""
    art = skew[0]
    batches = _batches(skew)
    eager = SearchEngine(art, cuda)
    eager._graphs = None
    eager._k_cold = 1
    want = _answers(eager, batches)
    for _ in range(2):
        engine = SearchEngine(art, cuda)
        engine._k_cold = 1
        got, errors = {}, []

        def serve(t):
            try:
                for _ in range(3):
                    got.setdefault(t, []).append(_answers(engine, batches))
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)
        threads = [threading.Thread(target=serve, args=(t,)) for t in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert engine.stats["graph_captures"] > 0
        for answers in got.values():
            assert answers == [want] * 3


def test_rle_counts_replayed_launches(skew, cuda):
    """stats["rle"] counts the same rle_sorted launches with graphs as
    without: one a chunk, hot + cold + legacy; the wrapper counts those
    it launched and none it recorded into a graph, the replays those
    recorded at their capture."""
    from kaamer_tpu_torch.ops import count

    art = skew[0]
    batches = _batches(skew)
    rle = []
    for on in (True, False):
        engine = SearchEngine(art, cuda)
        engine._k_cold = 1
        if not on:
            engine._graphs = None
        count.reset_launches()
        _answers(engine, batches)
        s = engine.stats
        assert s["rle"] == s["hot"] + s["cold"] + s["legacy"]
        assert (s["graph_replays"] > 0) == on
        assert (count.launches["rle_sorted_replayed"] > 0) == on
        assert s["rle"] == (count.launches["rle_sorted"]
                            + count.launches["rle_sorted_replayed"])
        rle.append(s["rle"])
    assert rle[0] == rle[1]
