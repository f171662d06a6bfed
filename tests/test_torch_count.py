"""Torch port vs JAX: run dedup, two-tier expansion, sort + RLE, top-k.
Exact equality: every output is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaamer_tpu.ops import count as cj
from kaamer_tpu_torch.ops import count as ct

SENT = 0xFFFFFFFF


def _np(x):
    return np.asarray(x).astype(np.int64)


def _slices(rng, B, L, P, max_len):
    """Per-position postings slices with runs of repeated slices (as
    consecutive k-mers of a shared domain resolve to one set)."""
    offs = np.zeros((B, L), np.int64)
    lens = np.zeros((B, L), np.int64)
    for b in range(B):
        l = 0
        while l < L:
            run = int(rng.integers(1, 6))
            ln = int(rng.integers(0, max_len))
            o = int(rng.integers(0, P - ln))
            offs[b, l:l + run] = o
            lens[b, l:l + run] = ln
            l += run
    return offs, lens


def test_dedup_runs():
    rng = np.random.default_rng(1)
    offs, lens = _slices(rng, 6, 40, 1000, 30)
    want = cj.dedup_runs(jnp.asarray(offs, jnp.int32),
                         jnp.asarray(lens, jnp.int32))
    got = ct.dedup_runs(torch.from_numpy(offs), torch.from_numpy(lens))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def _tiers(offs, lens, t_split):
    """Phase-1 tier split (engine.py:1139-1149) on numpy inputs."""
    lens_u, wstart, _ = (_np(x) for x in cj.dedup_runs(
        jnp.asarray(offs, jnp.int32), jnp.asarray(lens, jnp.int32)))
    long = lens_u >= t_split
    cum_s = np.cumsum(np.where(long, 0, lens_u), axis=1)
    cum_t = np.cumsum(np.where(long, ((offs & 127) + lens_u + 127) >> 7, 0),
                      axis=1)
    lens_l = np.where(long, lens_u, 0)
    return cum_s, wstart, cum_t, lens_l


@pytest.mark.parametrize("t_split,extra_t", [(10**9, 0), (24, 0), (24, 5)])
def test_expand_hybrid(t_split, extra_t):
    """cap_t == 0 (element tier only) and cap_t > 0 (tile tier), with
    padding lanes past each query's total."""
    rng = np.random.default_rng(t_split + extra_t)
    P = 128 * 40
    postings = np.sort(rng.integers(0, 2**31, size=P, dtype=np.uint64)
                       ).astype(np.uint32)
    offs, lens = _slices(rng, 5, 32, P, 90)
    cum_s, wstart, cum_t, lens_l = _tiers(offs, lens, t_split)
    cap_s = int(cum_s[:, -1].max()) + 17
    cap_t = int(cum_t[:, -1].max()) + extra_t
    want = cj.expand_hybrid(jnp.asarray(postings), *(
        jnp.asarray(x, jnp.int32) for x in (offs, cum_s, wstart, cum_t,
                                            lens_l)), cap_s, cap_t)
    got = ct.expand_hybrid(torch.from_numpy(postings.view(np.int32)), *(
        torch.from_numpy(x) for x in (offs, cum_s, wstart, cum_t, lens_l)),
        cap_s, cap_t)
    for name, w, g in zip(("rows", "seg", "valid", "w"), want, got):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    assert (cap_t > 0) == (t_split < 10**9)


def _rows_weights(rng, B, cap, n_rows):
    rows = rng.integers(0, n_rows, size=(B, cap)).astype(np.uint32)
    rows[rng.random((B, cap)) < 0.3] = SENT
    w = np.where(rows == SENT, 0, rng.integers(1, 9, size=(B, cap)))
    return rows, w.astype(np.int32)


@pytest.mark.parametrize("branch", ["unweighted", "packed", "two_operand"])
def test_sort_rle_one_path_matches_both_jax_branches(branch):
    rng = np.random.default_rng(7)
    rows, w = _rows_weights(rng, 4, 300, 40)
    if branch == "unweighted":
        want = cj.sort_rle(jnp.asarray(rows))
        got = ct.sort_rle(torch.from_numpy(rows.astype(np.int64)))
    else:
        want = cj.sort_rle(jnp.asarray(rows), jnp.asarray(w),
                           pack_w_bits=9 if branch == "packed" else 0)
        got = ct.sort_rle(torch.from_numpy(rows.astype(np.int64)),
                          torch.from_numpy(w.astype(np.int64)))
    for name, wv, g in zip(("s", "counts", "is_start"), want, got):
        np.testing.assert_array_equal(_np(g), _np(wv), err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_count_topk_tie_heavy(weighted):
    """Rows from a tiny id range with equal weights: most counts tie, so
    the (count desc, row asc) order decides every rank."""
    rng = np.random.default_rng(3)
    rows = np.repeat(rng.permutation(np.arange(60, dtype=np.uint32)), 4)
    rows = np.stack([rng.permutation(rows) for _ in range(5)])
    rows[:, -20:] = SENT
    w = np.where(rows == SENT, 0, 2).astype(np.int32)
    k = 32
    if weighted:
        want = cj.count_topk(jnp.asarray(rows), k, jnp.asarray(w),
                             pack_w_bits=4)
        got = ct.count_topk(torch.from_numpy(rows.astype(np.int64)), k,
                            torch.from_numpy(w.astype(np.int64)))
    else:
        want = cj.count_topk(jnp.asarray(rows), k)
        got = ct.count_topk(torch.from_numpy(rows.astype(np.int64)), k)
    for wv, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(wv))
    # the row-0 ranking: 60 rows tie at the top count, lowest ids first
    assert got[1][0, :5].tolist() == sorted(got[1][0, :5].tolist())


def _old_chain(rows, w):
    """sort_weighted + rle_weighted + merge_hot_cold_tam's injected-head
    flag as the port computed them before rle_sorted: (s, counts int64,
    is_start, inj)."""
    key = torch.where(rows == SENT, ct._KEY_SENTINEL, (rows << 32) | w)
    ks = torch.sort(key, dim=1).values
    sent = ks == ct._KEY_SENTINEL
    s = torch.where(sent, SENT, ks >> 32)
    wv = torch.where(sent, 0, ks & 0xFFFFFFFF)
    edge = torch.ones_like(s[:, :1], dtype=torch.bool)
    differs = s[:, 1:] != s[:, :-1]
    is_start = torch.cat([edge, differs], dim=1) & (s != SENT)
    change_next = torch.cat([differs, edge], dim=1)
    wc = torch.cumsum(wv, dim=1)
    wc_end = torch.flip(torch.cummin(torch.flip(
        torch.where(change_next, wc, 2**62), [1]), dim=1).values, [1])
    counts = torch.where(is_start, wc_end - wc + wv, 0)
    return s, counts, is_start, is_start & (wv == 0)


def _rle_entries(rng, case):
    """(rows, weights) int64 of the kernel tests' cases, at CPU sizes."""
    G, n, n_rows, pad, zero_w = {
        "random": (16, 5000, 300, 0.2, 0.0),
        "one_run": (4, 3000, 1, 0.0, 0.0),
        "tile_edges": (3, 12_000, 12, 0.1, 0.0),
        "all_sentinel": (5, 700, 10, 1.0, 0.0),
        "injected": (8, 2000, 200, 0.2, 0.1),
        "ragged": (7, 1037, 50, 0.2, 0.0),
        "one_long_row": (1, (1 << 21) + 64, 1 << 15, 0.2, 0.0),
        "many_short_rows": (2048, 64, 20, 0.2, 0.05)}[case]
    rows = rng.integers(0, n_rows, size=(G, n)).astype(np.int64)
    w = rng.integers(1, 9, size=(G, n)).astype(np.int64)
    w[rng.random((G, n)) < zero_w] = 0
    rows[rng.random((G, n)) < pad] = SENT
    w[rows == SENT] = 0
    return torch.from_numpy(rows), torch.from_numpy(w)


@pytest.mark.parametrize("case", ["random", "one_run", "tile_edges",
                                  "all_sentinel", "injected", "ragged",
                                  "one_long_row", "many_short_rows"])
def test_rle_sorted_plain_equals_the_old_chain(case):
    """rle_sorted on the CPU (its plain version) gives what sort_weighted
    + rle_weighted + the injected-head flag gave, and its rank keys are
    merge_hot_cold_tam's keys built from those."""
    rows, w = _rle_entries(np.random.default_rng(len(case)), case)
    s0, c0, st0, inj0 = _old_chain(rows, w)
    ks = ct.sort_weighted(rows, w)
    s, c, st, inj = ct.rle_sorted(ks)
    assert c.dtype == torch.int32
    for got, want in ((s, s0), (c, c0.to(torch.int32)), (st, st0),
                      (inj, inj0)):
        assert torch.equal(got, want)
    for skip_inj in (False, True):
        hkey, ckey = ct.rle_sorted(ks, rank_keys=True, skip_inj=skip_inj)
        pop = st0 & (c0 > 0) & ~(inj0 & skip_inj)
        assert torch.equal(hkey, torch.where(inj0, (s0 << 32) | c0,
                                             ct._KEY_SENTINEL))
        assert torch.equal(ckey, torch.where(pop, (-c0 << 32) | s0,
                                             ct._KEY_SENTINEL))
    if case == "injected":
        assert inj.any()
    if case == "all_sentinel":
        assert not st.any() and not c.any()


def test_rle_sorted_rejects_bad_arguments():
    ks = ct.sort_weighted(*_rle_entries(np.random.default_rng(0), "ragged"))
    with pytest.raises(ValueError):
        ct.rle_sorted(ks.int())
    with pytest.raises(ValueError):
        ct.rle_sorted(ks.t())
    with pytest.raises(ValueError):
        ct.rle_sorted(ks[0])
    with pytest.raises(ValueError):
        ct.rle_sorted(ks.to("meta"))


def test_member_np_copy_matches():
    rng = np.random.default_rng(9)
    postings = np.concatenate([np.sort(rng.choice(500, 40, replace=False))
                               for _ in range(10)]).astype(np.uint32)
    offs = rng.integers(0, 10, size=25).astype(np.int64) * 40
    lens = np.full(25, 40, np.int64)
    lens[::4] = 0
    hits = rng.choice(500, 30, replace=False).astype(np.uint32)
    np.testing.assert_array_equal(ct.member_np(postings, offs, lens, hits),
                                  cj.member_np(postings, offs, lens, hits))
