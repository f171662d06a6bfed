"""Torch port vs JAX: the hot-set primitives (ops/hotset.py) on the same
numpy inputs, exact equality, plus the threshold merge's brute-force fuzz
and certificate-soundness cases of tests/test_hotset.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaamer_tpu.ops import hotset as jh
from kaamer_tpu_torch.ops import hotset as th

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENT = 0xFFFFFFFF


def _rows_t(rows_u32):
    return torch.from_numpy(np.asarray(rows_u32).astype(np.int64))


def _offsets(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.uint64)


@pytest.mark.parametrize("lens,num_p,h_max", [
    (np.arange(1, 101), 200, 10),                                 # plain cut
    (np.full(12, 30), 64, 4),                                     # all tied
    (np.concatenate([np.full(3, 50), np.full(12, 30)]), 64, 4),   # tie tier
    (np.linspace(24, 30000, num=3000).astype(np.int64), 1_000_000, 1024),
    (np.arange(5), 10, 2048),                                     # none
])
def test_select_hot_sets(lens, num_p, h_max):
    off = _offsets(lens)
    want = jh.select_hot_sets(off, num_p, h_max=h_max)
    got = th.select_hot_sets(off, num_p, h_max=h_max)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1:] == want[1:]


def _membership_case(rng, P_pad, H, dense):
    lens = rng.integers(24, 24 + dense, size=H)
    off = _offsets(lens)
    postings = np.concatenate([
        np.sort(rng.choice(P_pad - 5, size=int(n), replace=False))
        for n in lens]).astype(np.uint32)
    return postings, off, off[:-1].astype(np.int32)


@pytest.mark.parametrize("P_pad,H", [(256, 4), (1 << 17, 130)])  # f32, bf16
def test_build_membership(P_pad, H):
    rng = np.random.default_rng(P_pad)
    postings, off, hs = _membership_case(rng, P_pad, H, 60)
    want = np.asarray(jh.build_membership(postings, off, hs, P_pad))
    got = th.build_membership(postings, off, hs, P_pad, "cpu")
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(
        th.build_membership_np(postings, off, hs, P_pad),
        jh.build_membership_np(postings, off, hs, P_pad))


@pytest.mark.parametrize("L", [64, 512])
def test_hot_weights(L):
    rng = np.random.default_rng(L)
    G, H = 6, 20
    hot_starts = np.sort(rng.choice(10_000, size=H, replace=False)).astype(
        np.int32)
    offs = rng.choice(np.concatenate([hot_starts, [3, 5, 10_001]]),
                      size=(G, L)).astype(np.int32)
    whot = np.where(np.isin(offs, hot_starts) & (rng.random((G, L)) < 0.5),
                    rng.integers(1, 9, size=(G, L)), 0).astype(np.int32)
    want = np.asarray(jh.hot_weights(jnp.asarray(offs), jnp.asarray(whot),
                                     jnp.asarray(hot_starts)))
    got = th.hot_weights(torch.from_numpy(offs.astype(np.int64)),
                         torch.from_numpy(whot.astype(np.int64)),
                         torch.from_numpy(hot_starts))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0


@pytest.mark.parametrize("max_w", [256, 512])
@pytest.mark.parametrize("m_dtype", ["bf16", "f32"])
def test_hot_matmul(max_w, m_dtype):
    """The bf16 hi/lo split above 256 and the f32 M path, against JAX and
    an int64 reference (sums well above 256)."""
    rng = np.random.default_rng(3)
    G, H, P = 8, 64, 384
    M_np = (rng.random((H, P)) < 0.3).astype(np.float32)
    W_np = rng.integers(0, max_w + 1, size=(G, H)).astype(np.float32)
    if max_w > 256:
        W_np[0, 0], W_np[1, 1] = 257.0, 511.0
    ref = W_np.astype(np.int64) @ M_np.astype(np.int64)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if m_dtype == "bf16"
              else (jnp.float32, torch.float32))
    want = np.asarray(jh.hot_matmul(jnp.asarray(W_np),
                                    jnp.asarray(M_np, dtype=jd), max_w=max_w))
    got = th.hot_matmul(torch.from_numpy(W_np),
                        torch.from_numpy(M_np).to(td), max_w=max_w)
    assert got.dtype == torch.float32 and ref.max() > 256
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ref)


def test_hot_matmul_bf16_out():
    """The engine's L <= 256 form: bf16 result of counts <= 256."""
    rng = np.random.default_rng(4)
    M_np = (rng.random((32, 512)) < 0.2).astype(np.float32)
    W_np = np.zeros((4, 32), np.float32)
    for g in range(4):
        W_np[g, rng.choice(32, size=5, replace=False)] = rng.integers(1, 50, 5)
    want = np.asarray(jh.hot_matmul(
        jnp.asarray(W_np), jnp.asarray(M_np, dtype=jnp.bfloat16), max_w=256,
        out_dtype=jnp.bfloat16)).astype(np.float32)
    got = th.hot_matmul(torch.from_numpy(W_np),
                        torch.from_numpy(M_np).to(torch.bfloat16), max_w=256,
                        out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("P,ties", [(1024, False), (32768, False),
                                    (32768, True)])
def test_topk_dense(P, ties):
    """Direct (P=1024), hierarchical (P=32768) with dense ties, and tile
    boundary ties (one equal top value in every tile)."""
    rng = np.random.default_rng(7)
    G, k = 8, 32
    if ties:
        vals = np.zeros((G, P), np.float32)
        vals[:, np.arange(0, P, 128) + 77] = 5.0
    else:
        vals = rng.integers(0, 6, size=(G, P)).astype(np.float32)
    wv, wi = jh.topk_dense(jnp.asarray(vals), k)
    gv, gi = th.topk_dense(torch.from_numpy(vals), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi).astype(np.int64))
    gb, gbi = th.topk_dense(torch.from_numpy(vals).to(torch.bfloat16), k)
    np.testing.assert_array_equal(gbi.numpy(), gi.numpy())


def _cold_multiset(rng, G, P, cap, pad_p=0.3, wmax=6):
    rows = rng.integers(0, P, size=(G, cap)).astype(np.uint32)
    w = rng.integers(1, wmax, size=(G, cap)).astype(np.int32)
    pad = rng.random((G, cap)) < pad_p
    rows[pad] = SENT
    w[pad] = 0
    return rows, w


def _sort_rle_np(rows, w):
    """Sorted rows, RLE counts and starts as the JAX sort_rle gives them."""
    from kaamer_tpu.ops.count import sort_rle

    s, c, st = sort_rle(jnp.asarray(rows), jnp.asarray(w))
    return np.asarray(s), np.asarray(c), np.asarray(st)


@pytest.mark.parametrize("k_hot", [0, 40])
def test_merge_hot_cold(k_hot):
    rng = np.random.default_rng(5 + k_hot)
    G, P, cap, k = 8, 8192, 256, 16
    counts_hot = (rng.integers(0, 9, size=(G, P))
                  * (rng.random((G, P)) < 0.02)).astype(np.float32)
    rows, w = _cold_multiset(rng, G, P, cap)
    rows[:, :40] = rng.choice(np.flatnonzero(counts_hot[0]), size=(G, 40))
    w[:, :40] = 1
    s, c, st = _sort_rle_np(rows, w)
    wc, wr = jh.merge_hot_cold(jnp.asarray(counts_hot), jnp.asarray(s),
                               jnp.asarray(c), jnp.asarray(st), k,
                               k_hot=k_hot, pack_w_bits=9)
    gc, gr = th.merge_hot_cold(torch.from_numpy(counts_hot), _rows_t(s),
                               torch.from_numpy(c.copy()),
                               torch.from_numpy(st.copy()), k, k_hot=k_hot)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr).astype(np.int64))


def _tam_both(counts_hot, rows, w, k, pack_w_bits, **kw):
    want = jh.merge_hot_cold_tam(jnp.asarray(counts_hot), jnp.asarray(rows),
                                 jnp.asarray(w), k, pack_w_bits=pack_w_bits,
                                 **kw)
    got = th.merge_hot_cold_tam(torch.from_numpy(counts_hot), _rows_t(rows),
                                torch.from_numpy(w.astype(np.int64)), k,
                                pack_w_bits=pack_w_bits, **kw)
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    assert got[2].dtype == np.bool_
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1].astype(np.int64))
    np.testing.assert_array_equal(got[2], want[2])
    return got


def _tam_oracle(counts_hot, rows, w, k):
    """Brute-force (count desc, row asc) top-k of hot + cold totals."""
    G, P = counts_hot.shape
    outc = np.zeros((G, k), np.int32)
    outr = np.full((G, k), SENT, np.int64)
    for g in range(G):
        tot = counts_hot[g].astype(np.int64).copy()
        real = rows[g] != np.uint32(SENT)
        np.add.at(tot, rows[g][real].astype(np.int64), w[g][real])
        nz = np.flatnonzero(tot)
        order = np.lexsort((nz, -tot[nz]))[:k]
        outc[g, : order.size] = tot[nz[order]]
        outr[g, : order.size] = nz[order]
    return outc, outr


@pytest.mark.parametrize("pack_w_bits", [9, 0])
@pytest.mark.parametrize("seed", [3, 4, 5, 6, 7])
def test_merge_tam_fuzz(pack_w_bits, seed):
    """TAM on random multisets equals JAX (all three outputs, both
    branches) and every certified row equals the brute force.  Seeds 6
    and 7 draw the cold rows from the hot candidates' range, so that most
    injected entries join a cold run (their heads then carry a cold
    count: rle_sorted's rank keys)."""
    rng = np.random.default_rng(seed)
    G, P, cap, k = 16, 4096, 512, 16
    counts_hot = (rng.integers(0, 9, size=(G, P))
                  * (rng.random((G, P)) < 0.02)).astype(np.float32)
    rows, w = _cold_multiset(rng, G, P, cap)
    if seed >= 6:
        hot = np.flatnonzero(counts_hot.max(axis=0))
        real = rows != SENT
        rows[real] = rng.choice(hot, size=int(real.sum()))
    c, h, ex = _tam_both(counts_hot, rows, w, k, pack_w_bits)
    wc, wh = _tam_oracle(counts_hot, rows, w, k)
    assert ex.sum() > G // 2
    np.testing.assert_array_equal(c[ex], wc[ex])
    np.testing.assert_array_equal(h[ex], wh[ex])


@pytest.mark.parametrize("pack_w_bits", [9, 0])
def test_merge_tam_small_k_cold_flags_sound(pack_w_bits):
    """A starved cold list (k_cold = k) flags rows; the flag is sound: every
    certified row equals the brute force, and both agree with JAX."""
    rng = np.random.default_rng(17)
    G, P, cap, k = 24, 2048, 384, 16
    counts_hot = (rng.integers(0, 4, size=(G, P))
                  * (rng.random((G, P)) < 0.05)).astype(np.float32)
    rows, w = _cold_multiset(rng, G, 300, cap, pad_p=0.1, wmax=3)
    c, h, ex = _tam_both(counts_hot, rows, w, k, pack_w_bits, k_cold=k)
    wc, wh = _tam_oracle(counts_hot, rows, w, k)
    assert 0 < ex.sum() < G
    np.testing.assert_array_equal(c[ex], wc[ex])
    np.testing.assert_array_equal(h[ex], wh[ex])


@pytest.mark.parametrize("pack_w_bits", [9, 0])
@pytest.mark.parametrize("case", ["plateau", "disjoint", "overlap"])
def test_merge_tam_certificate_cases(pack_w_bits, case):
    """tests/test_hotset.py's certificate cases: a uniform plateau is
    certified, disjoint flat tiers wider than CAND_K are flagged, and an
    H2/C1 overlap leaves no duplicate hit row."""
    G, k = 4, 16
    cap = 4 * th.CAND_K
    if case == "overlap":
        rng = np.random.default_rng(11)
        G, P, cap = 8, 2048, 256
        counts_hot = np.zeros((G, P), np.float32)
        for g in range(G):
            counts_hot[g, rng.integers(0, 64, size=8)] = rng.integers(5, 50, 8)
        rows = rng.integers(0, 64, size=(G, cap)).astype(np.uint32)
    else:
        P = 8192
        rows = np.tile(np.arange(cap, dtype=np.uint32), (G, 1))
        counts_hot = np.zeros((G, P), np.float32)
        lo = 0 if case == "plateau" else 4096
        counts_hot[:, lo:lo + cap] = 1.0
    w = np.ones((G, cap), np.int32)
    c, h, ex = _tam_both(counts_hot, rows, w, k, pack_w_bits)
    if case == "plateau":
        assert ex.all()
        np.testing.assert_array_equal(c, np.full((G, k), 2))
        np.testing.assert_array_equal(h, np.tile(np.arange(k), (G, 1)))
    elif case == "disjoint":
        assert not ex.any()
    else:
        wc, wh = _tam_oracle(counts_hot, rows, w, k)
        for g in range(G):
            real = h[g][c[g] > 0]
            assert len(set(real.tolist())) == len(real)
        np.testing.assert_array_equal(c[ex], wc[ex])
        np.testing.assert_array_equal(h[ex], wh[ex])


def test_merge_tam_rejects_rows_beyond_its_keys():
    z = torch.zeros((1, 1 << 16), dtype=torch.float32)
    rows = torch.zeros((1, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^16"):
        th.merge_hot_cold_tam(z, rows, torch.ones_like(rows), 16)
    with pytest.raises(ValueError, match="2\\^22"):
        th.merge_hot_cold_tam(torch.zeros((1, 1 << 22)), rows,
                              torch.ones_like(rows), 16, pack_w_bits=9)


def test_hotset_module_never_imports_jax():
    code = ("import sys\n"
            "import kaamer_tpu_torch.ops.hotset\n"
            "import kaamer_tpu_torch.search.engine\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
