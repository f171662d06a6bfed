"""Torch port vs JAX: the engine's phase 1 (all ten outputs) and cold
phase 2, on a small domain-skewed database.  Exact equality.  Each
package loads the artifact with its own load_db."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaamer_tpu import codec
from kaamer_tpu.index.artifact import load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.search import engine as je
from kaamer_tpu_torch.index.artifact import load_db as torch_load_db
from kaamer_tpu_torch.search import engine as te

AA = "ACDEFGHIKLMNPQRSTVWY"


def _skewed_fasta(path, rng, n, n_dom=10):
    """Proteins built from 1-3 power-law-popular domains with random
    linkers: long, shared postings sets, as on real protein databases."""
    doms = ["".join(rng.choice(list(AA), size=int(rng.integers(30, 80))))
            for _ in range(n_dom)]
    pop = 1.0 / (np.arange(n_dom) + 2.0)
    pop /= pop.sum()
    seqs = []
    with open(path, "w") as f:
        for i in range(n):
            parts = []
            for _ in range(int(rng.integers(1, 4))):
                parts.append("".join(rng.choice(list(AA),
                                                size=int(rng.integers(5, 30)))))
                parts.append(doms[int(rng.choice(n_dom, p=pop))])
            seqs.append("".join(parts))
            f.write(f">T{i:05d} test protein {i}\n{seqs[-1]}\n")
    return seqs


@pytest.fixture(scope="module")
def skew(tmp_path_factory):
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("torch_phases")
    seqs = _skewed_fasta(str(tmp / "db.fasta"), rng, 300)
    build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")
    art = load_db(str(tmp / "db"))
    queries = []
    for _ in range(24):
        s = list(seqs[int(rng.integers(0, len(seqs)))])
        for _ in range(int(rng.integers(0, 5))):
            s[int(rng.integers(0, len(s)))] = AA[int(rng.integers(0, 20))]
        queries.append("".join(s))
    queries.append("MK")  # shorter than a k-mer: an all-padding row
    return art, queries


def _phase1_both(art, queries, hot_thresh):
    sizes = [max(len(q) - 6, 0) for q in queries]
    L = je._next_pow2(max(max(sizes), 8))
    width = L + 6
    wire = codec.pack_codes7(codec.pad_codes_batch(queries, width))
    miss = int(np.asarray(art.set_offsets)[-1])
    jt = je.SearchEngine(art, hot=False)
    want = je._phase1_impl(jt.table, jnp.asarray(wire),
                           jnp.asarray(sizes, jnp.int32),
                           hash_log2=art.hash_log2, miss_start=miss,
                           hot_thresh=hot_thresh, width=width)
    state = te.engine_state_from_artifact(torch_load_db(art.path), "cpu")
    got = te._phase1_impl(state["table"],
                          torch.from_numpy(wire.view(np.int32)),
                          torch.tensor(sizes), hash_log2=art.hash_log2,
                          miss_start=miss, hot_thresh=hot_thresh, width=width)
    return jt, state, want, got


@pytest.mark.parametrize("hot_thresh", [1 << 30, 40])
def test_phase1_all_outputs(skew, hot_thresh):
    art, queries = skew
    _, _, want, got = _phase1_both(art, queries, hot_thresh)
    assert len(got) == len(want) == 10
    for n, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64),
                                      err_msg=f"output {n}")
    # the skewed DB really exercises both cold tiers, or the hot split
    assert int(got[7].max()) > 0
    if hot_thresh == 40:
        assert int(got[9].max()) > 0
    else:
        assert int(got[8].max()) > 0 and int(got[9].max()) == 0


@pytest.mark.parametrize("rows", [None, [3, 0, 7, 12]])
def test_phase2_grouped(skew, rows):
    art, queries = skew
    jt, state, want1, got1 = _phase1_both(art, queries, 1 << 30)
    idx = list(range(len(queries))) if rows is None else rows
    ts = np.asarray(want1[7])[idx]
    tt = np.asarray(want1[8])[idx]
    cap_s = je._cap_bucket(int(ts.max()))
    cap_t = max(32, je._next_pow2(int(tt.max()))) if tt.max() else 0
    k = 16
    sel_j = [jnp.take(a, jnp.asarray(idx), axis=0) for a in want1[:7]]
    want = je._phase2_grouped_impl(jt.postings, *sel_j[:4], sel_j[5],
                                   sel_j[6], cap_s=cap_s, cap_t=cap_t, k=k,
                                   pack_w_bits=jt._pack_w_bits(
                                       want1[0].shape[1]))
    sel_t = [a[idx] for a in got1[:7]]
    got = te._phase2_grouped_impl(state["postings"], *sel_t[:3], sel_t[5],
                                  sel_t[6], cap_s=cap_s, cap_t=cap_t, k=k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1]).astype(np.int64))
    assert cap_t > 0 and int(got[0][:, 0].max()) > 0


def test_phase1_tier_boundary():
    """Runs of length T_SPLIT - 1, T_SPLIT and T_SPLIT + 1 on one query
    split exactly where the JAX phase 1 splits them (element tier below
    T_SPLIT, tile tier from it)."""
    from kaamer_tpu.index.hashtable import build_table

    rng = np.random.default_rng(2)
    seq = "".join(rng.choice(list(AA), size=40))
    kmers = codec.encode_kmers(codec.seq_to_codes(seq))
    keys, first = np.unique(kmers, return_index=True)
    lens = np.array([je.T_SPLIT - 1, je.T_SPLIT, je.T_SPLIT + 1, 5])[
        first % 4].astype(np.uint32)
    starts = rng.integers(0, 10_000, size=keys.size).astype(np.uint32)
    ht = build_table(keys, starts, lens)
    width = 40
    wire = codec.pack_codes7(codec.pad_codes_batch([seq], width))
    n = [len(seq) - 6]
    want = je._phase1_impl(jnp.asarray(ht.table), jnp.asarray(wire),
                           jnp.asarray(n, jnp.int32), hash_log2=ht.log2,
                           miss_start=20_000, width=width)
    got = te._phase1_impl(torch.from_numpy(ht.table.view(np.int32)),
                          torch.from_numpy(wire.view(np.int32)),
                          torch.tensor(n), hash_log2=ht.log2,
                          miss_start=20_000, width=width)
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64),
                                      err_msg=f"output {k}")
    assert int(got[6].max()) == je.T_SPLIT + 1   # lens_l: long runs kept
    assert (got[6][got[6] > 0] >= je.T_SPLIT).all()


@pytest.fixture(scope="module")
def hot_inputs(skew):
    """Phase 1 of both packages at the JAX engine's hot threshold, with the
    hot sets and membership matrix of both engines."""
    art, queries = skew
    jh = je.SearchEngine(art)
    th = te.SearchEngine(torch_load_db(art.path), "cpu")
    assert jh.hot_starts is not None and th.hot_thresh == jh.hot_thresh
    _, state, want1, got1 = _phase1_both(art, queries, jh.hot_thresh)
    assert int(got1[9].max()) > 0
    return jh, th, want1, got1


def _hot_group(want1, got1, idx):
    ts = np.asarray(want1[7])[idx]
    tt = np.asarray(want1[8])[idx]
    cap_s = je._cap_bucket(int(ts.max()))
    cap_t = max(32, je._next_pow2(int(tt.max()))) if tt.max() else 0
    sel_j = [jnp.take(a, jnp.asarray(idx), axis=0) for a in want1[:7]]
    sel_t = [a[idx] for a in got1[:7]]
    return cap_s, cap_t, sel_j, sel_t


@pytest.mark.parametrize("rows", [None, [3, 0, 7, 12]])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("k_cold", [64, 16])
def test_phase2_hot(hot_inputs, rows, pack, k_cold):
    """_phase2_hot_impl: all three outputs, certificate included, for the
    TAM merge's packed and unpacked branches and a starved cold list."""
    jh, th, want1, got1 = hot_inputs
    L = want1[0].shape[1]
    idx = list(range(want1[0].shape[0])) if rows is None else rows
    cap_s, cap_t, sj, st = _hot_group(want1, got1, idx)
    pw = jh._pack_w_bits(L) if pack else 0
    want = je._phase2_hot_impl(jh.postings, jh.M, jh.MT, jh.hot_starts, *sj,
                               cap_s=cap_s, cap_t=cap_t, k=16, pack_w_bits=pw,
                               k_cold=k_cold)
    got = te._phase2_hot_impl(th.postings, th.M, th.hot_starts, st[0], st[1],
                              st[2], st[4], st[5], st[6], cap_s=cap_s,
                              cap_t=cap_t, k=16, pack_w_bits=pw, k_cold=k_cold)
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1]).astype(np.int64))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[0][:, 0].max()) > 0


@pytest.mark.parametrize("rows", [None, [5, 1, 9]])
def test_phase2_hot_legacy(hot_inputs, rows):
    jh, th, want1, got1 = hot_inputs
    idx = list(range(want1[0].shape[0])) if rows is None else rows
    cap_s, cap_t, sj, st = _hot_group(want1, got1, idx)
    want = je._phase2_hot_legacy_impl(
        jh.postings, jh.M, jh.MT, jh.hot_starts, *sj, cap_s=cap_s,
        cap_t=cap_t, k=16, pack_w_bits=jh._pack_w_bits(want1[0].shape[1]))
    got = te._phase2_hot_legacy_impl(
        th.postings, th.M, th.hot_starts, st[0], st[1], st[2], st[4], st[5],
        st[6], cap_s=cap_s, cap_t=cap_t, k=16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1]).astype(np.int64))
