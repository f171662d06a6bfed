"""Torch port vs JAX: device position bitmaps (K11).

Module level, exact (bool / uint8, tolerance 0): member_bitmap_from_rows,
expand_run_bitmaps, pack_bits, hot_lane_mask and hot_position_bitmaps on
the same numpy-seeded inputs, and the three phase-2 functions with
positions=True.  Engine level: the port's device bitmaps equal the JAX
engine's and the host member_np's on a random and a skewed database, for
the hot and the cold engine, forced certificate re-runs (the legacy
merge's bitmaps) and the bitmap gate forced on and off; protein JSON with
positions is byte-equal to kaamer_tpu's in each case."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaamer_tpu import codec as jcodec
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.ops import count as jcount
from kaamer_tpu.ops import hotset as jhot
from kaamer_tpu.search import engine as je
from kaamer_tpu.search.options import PROTEIN
from kaamer_tpu.search.pipeline import run_search as jax_run_search
from kaamer_tpu.server.app import _default_options as jax_default_options
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.ops import count as tcount
from kaamer_tpu_torch.ops import hotset as thot
from kaamer_tpu_torch.search import engine as te
from kaamer_tpu_torch.search.pipeline import run_search
from kaamer_tpu_torch.server.app import _default_options

AA = "ACDEFGHIKLMNPQRSTVWY"
SENT = 0xFFFFFFFF


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------


def _rows_seg_hits(rng, B, cap, K, L, n_rows):
    """Expanded rows (distinct within each run lane, sentinel padding) with
    their run lanes, and top-k hits drawn from them plus absent rows and
    repeated sentinels."""
    rows = np.full((B, cap), SENT, np.uint32)
    seg = np.full((B, cap), L - 1, np.int32)
    hits = np.full((B, K), SENT, np.uint32)
    for b in range(B):
        n = int(rng.integers(0, cap + 1))
        lanes = np.sort(rng.integers(0, L, size=n))
        r = rng.integers(0, n_rows, size=n)
        # one row at most once per lane, as expansion of sorted slices gives
        key = np.unique(lanes.astype(np.int64) * n_rows + r)
        n = key.size
        rows[b, :n] = key % n_rows
        seg[b, :n] = key // n_rows
        perm = rng.permutation(cap)  # entries in any order
        rows[b], seg[b] = rows[b][perm], seg[b][perm]
        m = int(rng.integers(0, K + 1))
        pool = np.unique(np.concatenate([key % n_rows,
                                         rng.integers(0, n_rows, size=3)]))
        hits[b, :min(m, pool.size)] = rng.choice(pool, size=min(m, pool.size),
                                                 replace=False)
    return rows, seg, hits


@pytest.mark.parametrize("B,cap,K,L,seed", [
    (3, 40, 4, 16, 0), (5, 300, 16, 64, 1), (2, 1024, 32, 256, 2)])
def test_member_bitmap_from_rows(B, cap, K, L, seed):
    rng = np.random.default_rng(seed)
    rows, seg, hits = _rows_seg_hits(rng, B, cap, K, L, 50)
    want = np.asarray(jcount.member_bitmap_from_rows(
        jnp.asarray(rows), jnp.asarray(seg), jnp.asarray(hits), L))
    got = tcount.member_bitmap_from_rows(_t(rows), _t(seg), _t(hits), L)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and (~want).any()


def _run_starts(rng, B, L):
    """run_start of dedup_runs over offsets with repeated neighbours."""
    offs = np.cumsum(rng.integers(0, 2, size=(B, L)), axis=1).astype(np.int32)
    lens = rng.integers(0, 5, size=(B, L)).astype(np.int32)
    _, _, run_start = jcount.dedup_runs(jnp.asarray(offs), jnp.asarray(lens))
    return offs, np.asarray(run_start)


@pytest.mark.parametrize("B,K,L,seed", [(2, 3, 16, 0), (4, 16, 128, 1)])
def test_expand_run_bitmaps(B, K, L, seed):
    rng = np.random.default_rng(seed)
    _, run_start = _run_starts(rng, B, L)
    found = rng.random((B, K, L)) < 0.3
    want = np.asarray(jcount.expand_run_bitmaps(jnp.asarray(found),
                                                jnp.asarray(run_start)))
    got = tcount.expand_run_bitmaps(torch.from_numpy(found), _t(run_start))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(8,), (3, 5, 64), (2, 16, 512)])
def test_pack_bits(shape):
    rng = np.random.default_rng(len(shape))
    bits = rng.random(shape) < 0.4
    want = np.asarray(jcount.pack_bits(jnp.asarray(bits)))
    got = tcount.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.unpackbits(got.numpy(), axis=-1, bitorder="little").view(bool),
        bits)


@pytest.mark.parametrize("B,L,seed", [(3, 16, 0), (6, 256, 1)])
def test_hot_lane_mask(B, L, seed):
    rng = np.random.default_rng(seed)
    _, run_start = _run_starts(rng, B, L)
    whot = np.where(rng.random((B, L)) < 0.3,
                    rng.integers(1, 4, size=(B, L)), 0).astype(np.int32)
    want = np.asarray(jhot.hot_lane_mask(jnp.asarray(whot),
                                         jnp.asarray(run_start)))
    got = thot.hot_lane_mask(_t(whot), _t(run_start))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("G,L,K,H,P,seed", [(2, 16, 4, 3, 128, 0),
                                            (5, 64, 16, 40, 512, 1)])
def test_hot_position_bitmaps(G, L, K, H, P, seed):
    rng = np.random.default_rng(seed)
    hot_starts = np.sort(rng.choice(10_000, size=H, replace=False)).astype(
        np.int32)
    # lanes on hot set starts, on other starts, and on the miss start
    offs = np.where(rng.random((G, L)) < 0.5,
                    hot_starts[rng.integers(0, H, size=(G, L))],
                    rng.integers(0, 10_001, size=(G, L))).astype(np.int32)
    hot_lanes = rng.random((G, L)) < 0.7
    M = (rng.random((H, P)) < 0.3).astype(np.float32)
    hits = rng.integers(0, P, size=(G, K)).astype(np.uint32)
    hits[:, -1] = SENT
    MT_j = jnp.asarray(M).astype(jnp.bfloat16).T
    want = np.asarray(jhot.hot_position_bitmaps(
        jnp.asarray(offs), jnp.asarray(hot_lanes), jnp.asarray(hot_starts),
        MT_j, jnp.asarray(hits)))
    MT_t = torch.from_numpy(M).to(torch.bfloat16).t().contiguous()
    got = thot.hot_position_bitmaps(_t(offs), torch.from_numpy(hot_lanes),
                                    _t(hot_starts), MT_t, _t(hits))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and (~want).any()


# ---------------------------------------------------------------------------
# databases
# ---------------------------------------------------------------------------


def _write(path, seqs, prefix):
    with open(path, "w") as f:
        f.writelines(f">{prefix}{i:04d} protein {i}\n{s}\n"
                     for i, s in enumerate(seqs))


def _queries(rng, seqs, n):
    out = []
    for _ in range(n):
        s = list(seqs[int(rng.integers(0, len(seqs)))])
        for _ in range(int(rng.integers(0, 4))):
            s[int(rng.integers(0, len(s)))] = AA[int(rng.integers(0, 20))]
        out.append("".join(s))
    return out


def _build(tmp, seqs, prefix):
    _write(tmp / "db.fasta", seqs, prefix)
    build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")
    queries = _queries(np.random.default_rng(len(seqs)), seqs, 30)
    with open(tmp / "q.fasta", "w") as f:
        f.writelines(f">q{i} query\n{q}\n" for i, q in enumerate(queries))
    return tmp, queries


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """'random': uniform random proteins with a few shared segments (no
    hot sets); 'skewed': proteins of power-law-popular domains (hot
    sets)."""
    rng = np.random.default_rng(8)
    rand = ["".join(rng.choice(list(AA), size=int(rng.integers(40, 160))))
            for _ in range(120)]
    shared = "".join(rng.choice(list(AA), size=40))
    for i in (3, 4, 5):
        rand[i] = rand[i][:10] + shared + rand[i][10:]
    doms = ["".join(rng.choice(list(AA), size=int(rng.integers(20, 45))))
            for _ in range(40)]
    pop = 1.0 / (np.arange(40) + 2.0)
    pop /= pop.sum()
    skew = []
    for _ in range(300):
        parts = []
        for _ in range(int(rng.integers(1, 4))):
            parts.append("".join(rng.choice(list(AA),
                                            size=int(rng.integers(5, 15)))))
            parts.append(doms[int(rng.choice(40, p=pop))])
        skew.append("".join(parts))
    return {
        "random": _build(tmp_path_factory.mktemp("pos_random"), rand, "R"),
        "skewed": _build(tmp_path_factory.mktemp("pos_skewed"), skew, "S"),
    }


def _engines(dbs, kind, hot):
    tmp, queries = dbs[kind]
    art = load_db(str(tmp / "db"))
    port = te.SearchEngine(art, "cpu", hot=hot)
    jax_engine = je.SearchEngine(jax_load_db(str(tmp / "db")), hot=hot)
    return tmp, queries, port, jax_engine


def _gate(monkeypatch, on):
    """Force both engines' bitmap gate on or off (None leaves it)."""
    if on is not None:
        monkeypatch.setattr(te, "_positions_on_device", lambda *a: on)
        monkeypatch.setattr(je, "_positions_on_device", lambda *a: on)


def _check_bitmaps(port, jax_engine, got, want, device_expected):
    """The port's and the JAX engine's QueryCounts agree on hits and
    bitmaps, and the port's bitmaps equal member_np's."""
    n_dev = 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.hit_rows, b.hit_rows)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert (a._bitmaps is None) == (b._bitmaps is None)
        rows = [int(r) for r in a.hit_rows]
        mine = port.position_bitmaps_np(a, rows)
        host = port._host_bitmaps_np(a, rows)
        theirs = jax_engine.position_bitmaps_np(b, rows)
        assert mine.keys() == host.keys() == theirs.keys()
        for r in rows:
            np.testing.assert_array_equal(mine[r], host[r])
            np.testing.assert_array_equal(mine[r], theirs[r])
        if a._bitmaps is not None:
            n_dev += 1
            np.testing.assert_array_equal(
                a._bitmaps[: len(rows)], b._bitmaps[: len(rows)])
    if device_expected:
        assert n_dev == len(got)
    else:
        assert n_dev == 0


def _opts(path, defaults):
    o = defaults(PROTEIN)
    o.File, o.OutFormat, o.ExtractPositions = str(path), "json", True
    return o


@pytest.mark.parametrize("gate", [None, False])
@pytest.mark.parametrize("hot", [True, False])
@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_engine_bitmaps_and_json_equal_jax(dbs, kind, hot, gate, monkeypatch):
    """Device bitmaps (the gate as it stands at these sizes: on) or host
    bitmaps (gate forced off), from both packages, equal; protein JSON
    with positions is byte-equal."""
    _gate(monkeypatch, gate)
    tmp, queries, port, jax_engine = _engines(dbs, kind, hot)
    assert (port.hot_starts is not None) == (jax_engine.hot_starts
                                             is not None)
    if kind == "skewed" and hot:
        assert port.hot_starts is not None and port.MT is not None
        assert port.MT.shape == (port.M.shape[1], port.M.shape[0])
    sizes = [len(q) - 6 for q in queries]
    got = port.count_batch(queries, sizes, k=10, positions=True)
    want = jax_engine.count_batch(queries, sizes, k=10, positions=True)
    _check_bitmaps(port, jax_engine, got, want, device_expected=gate is None)
    body = b"".join(run_search(port, _opts(tmp / "q.fasta",
                                           _default_options)))
    assert body == b"".join(jax_run_search(
        jax_engine, _opts(tmp / "q.fasta", jax_default_options)))
    assert b'"PositionHits":{"' in body


def test_forced_reruns_return_bitmaps(dbs, monkeypatch):
    """_k_cold = 1 starves the TAM merge's cold list on both engines: the
    same rows fail the certificate and re-run through the legacy merge,
    whose chunks return device bitmaps equal to JAX's and member_np's."""
    tmp, _, port, jax_engine = _engines(dbs, "skewed", True)
    # database proteins repeated to 120 residues: wide plateaus of hot and
    # cold totals, which a starved cold candidate list cannot certify
    rng = np.random.default_rng(5)
    queries = [(port.art.sequence(int(rng.integers(
        0, port.art.num_proteins))) * 4)[:120] for _ in range(48)]
    port._k_cold = jax_engine._k_cold = 1
    legacy_pos = []
    orig = te._phase2_hot_legacy_impl

    def spy(*a, **kw):
        out = orig(*a, **kw)
        legacy_pos.append(kw["positions"] and len(out) == 3)
        return out

    monkeypatch.setattr(te, "_phase2_hot_legacy_impl", spy)
    sizes = [len(q) - 6 for q in queries]
    got = port.count_batch(queries, sizes, k=10, positions=True)
    want = jax_engine.count_batch(queries, sizes, k=10, positions=True)
    assert port.stats["rerun_rows"] > 0 and legacy_pos and all(legacy_pos)
    _check_bitmaps(port, jax_engine, got, want, device_expected=True)
    path = tmp / "rerun.fasta"
    path.write_text("".join(f">r{i} rerun\n{q}\n"
                            for i, q in enumerate(queries)))
    assert (b"".join(run_search(port, _opts(path, _default_options)))
            == b"".join(jax_run_search(jax_engine,
                                       _opts(path, jax_default_options))))


def test_host_slice_lookup_keeps_the_starts_dtype(dbs, monkeypatch):
    """The host bitmaps' and the host count's slice lookup searches the
    int32 set starts with int32 keys (int64 keys make numpy cast the whole
    starts array on every query) and finds the JAX engine's slices."""
    _, queries, port, jax_engine = _engines(dbs, "skewed", True)
    sizes = [len(q) - 6 for q in queries]
    got = port.count_batch(queries, sizes, k=10)
    want = jax_engine.count_batch(queries, sizes, k=10)
    handle = port.dispatch_batch(queries[:1], sizes[:1], k=10)
    keys_match = []
    search = np.searchsorted

    def spy(a, v, *args, **kw):
        if a is port.set_starts_np:
            keys_match.append(np.asarray(v).dtype == a.dtype)
        return search(a, v, *args, **kw)

    monkeypatch.setattr(np, "searchsorted", spy)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.offs, b.offs)
        np.testing.assert_array_equal(a.lens, b.lens)
    host = port._count_host_row(te._BatchIds(handle[0][0]), 0, sizes[0], 16)
    np.testing.assert_array_equal(host.lens, got[0].lens)
    np.testing.assert_array_equal(host.hit_rows, got[0].hit_rows)
    np.testing.assert_array_equal(host.counts, got[0].counts)
    assert len(keys_match) == len(got) + 1 and all(keys_match)


@pytest.fixture(scope="module")
def phase_inputs(dbs):
    """Phase 1 of both packages on the skewed database at the hot
    threshold, with both engines' hot sets, M and MT."""
    tmp, queries = dbs["skewed"]
    jh = je.SearchEngine(jax_load_db(str(tmp / "db")))
    th = te.SearchEngine(load_db(str(tmp / "db")), "cpu")
    sizes = [len(q) - 6 for q in queries]
    L = je._next_pow2(max(sizes))
    width = L + 6
    wire = jcodec.pack_codes7(jcodec.pad_codes_batch(queries, width))
    want1 = je._phase1_impl(jh.table, jnp.asarray(wire),
                            jnp.asarray(sizes, jnp.int32),
                            hash_log2=jh.hash_log2, miss_start=jh.miss_start,
                            hot_thresh=jh.hot_thresh, width=width)
    got1 = te._phase1_impl(th.table, torch.from_numpy(wire.view(np.int32)),
                           torch.tensor(sizes), hash_log2=th.hash_log2,
                           miss_start=th.miss_start,
                           hot_thresh=th.hot_thresh, width=width)
    assert int(got1[9].max()) > 0
    ts, tt = np.asarray(want1[7]), np.asarray(want1[8])
    cap_s = je._cap_bucket(int(ts.max()))
    cap_t = max(32, je._next_pow2(int(tt.max()))) if tt.max() else 0
    return jh, th, want1[:7], got1[:7], cap_s, cap_t


def _assert_outs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(
            g.numpy(), w.astype(np.int64) if w.dtype == np.uint32 else w)


@pytest.mark.parametrize("kind", ["grouped", "hot", "hot_untam", "legacy"])
def test_phase2_positions_outputs(phase_inputs, kind):
    """Every output of the phase-2 function with positions=True, packed
    bitmaps included, equals the JAX function's."""
    jh, th, sj, st, cap_s, cap_t = phase_inputs
    L = sj[0].shape[1]
    offs, cum_s, wstart, run_start, whot, cum_t, lens_l = st
    kw = dict(cap_s=cap_s, cap_t=cap_t, k=16, run_start=run_start,
              positions=True)
    if kind == "grouped":
        want = je._phase2_grouped_impl(jh.postings, *sj[:4], sj[5], sj[6],
                                       cap_s=cap_s, cap_t=cap_t, k=16,
                                       positions=True)
        got = te._phase2_grouped_impl(th.postings, offs, cum_s, wstart,
                                      cum_t, lens_l, **kw)
    elif kind == "legacy":
        want = je._phase2_hot_legacy_impl(
            jh.postings, jh.M, jh.MT, jh.hot_starts, *sj, cap_s=cap_s,
            cap_t=cap_t, k=16, positions=True,
            pack_w_bits=jh._pack_w_bits(L))
        got = te._phase2_hot_legacy_impl(
            th.postings, th.M, th.hot_starts, offs, cum_s, wstart, whot,
            cum_t, lens_l, MT=th.MT, **kw)
    else:
        pw = jh._pack_w_bits(L) if kind == "hot" else 0
        want = je._phase2_hot_impl(jh.postings, jh.M, jh.MT, jh.hot_starts,
                                   *sj, cap_s=cap_s, cap_t=cap_t, k=16,
                                   positions=True, pack_w_bits=pw,
                                   k_cold=16)
        got = te._phase2_hot_impl(th.postings, th.M, th.hot_starts, offs,
                                  cum_s, wstart, whot, cum_t, lens_l,
                                  MT=th.MT, pack_w_bits=pw, k_cold=16, **kw)
    _assert_outs(got, want)
    bits = got[-1].numpy()
    assert got[-1].dtype == torch.uint8 and bits.shape[-1] == L // 8
    assert bits.any()
