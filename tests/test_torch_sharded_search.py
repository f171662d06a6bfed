"""The port's last device functions against the JAX package's, exactly
(tolerance 0): the 3-residue wire codec (codec.pack_codes3 /
unpack_codes3), the single-tier postings expansion (ops/count.
gather_postings), the binary-search position bitmaps (ops/count.
member_bitmap) and the whole-batch sharded search step
(parallel/mesh.sharded_search, make_sharded_search's port) on the
conftest's virtual JAX CPU devices against port grids of "cpu"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kaamer_tpu import codec as jax_codec
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.ops import count as jax_count
from kaamer_tpu.parallel import mesh as jax_mesh
from kaamer_tpu_torch import codec
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.ops import count
from kaamer_tpu_torch.parallel import mesh
from kaamer_tpu_torch.parallel.dist import Mesh
from kaamer_tpu_torch.search.engine import SearchEngine
from test_torch_dist import shards  # noqa: F401 -- the module fixture

# (dp, shard) grids of the port, each with its JAX mesh of as many of the
# conftest's virtual devices
GRIDS = {"1x2": (1, 2), "1x4": (1, 4), "2x4": (2, 4)}


def _meshes(name):
    dp, n = GRIDS[name]
    jm = JaxMesh(np.array(jax.devices()[: dp * n]).reshape(dp, n),
                 axis_names=("dp", "shard"))
    return Mesh([["cpu"] * n for _ in range(dp)]), jm


def _u32(x):
    """A torch int32 view of uint32 words as the port keeps postings."""
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# the 3-residue wire codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 3, 7, 62, 63, 64, 262])
def test_pack_codes3_equals_jax(width):
    """pack_codes3's words and unpack_codes3's codes equal the JAX
    package's for every width mod 3 (test_codec.py's widths), with -1
    padding and the words held as uint16, int16, int32 and int64."""
    rng = np.random.default_rng(5 + width)
    codes = rng.integers(-1, codec.N_AA, size=(4, width)).astype(np.int8)
    codes[0, :] = codec.N_AA - 1  # the largest word, 10647
    packed = codec.pack_codes3(codes)
    want = jax_codec.pack_codes3(codes)
    assert packed.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(packed, want)
    unpacked = np.asarray(jax_codec.unpack_codes3_jnp(want, width))
    for dtype in (np.uint16, np.int16, np.int32, np.int64):
        got = codec.unpack_codes3(torch.from_numpy(packed.astype(dtype)),
                                  width)
        assert got.dtype == torch.int64 and got.shape == (4, width)
        np.testing.assert_array_equal(got.numpy(), unpacked)
    np.testing.assert_array_equal(unpacked, codes)


# ---------------------------------------------------------------------------
# gather_postings
# ---------------------------------------------------------------------------


def _slices(rng, B, L, P, max_len, empty):
    """Sorted postings uint32[P] and per-lane slices inside them: a share
    `empty` of the lanes has length 0."""
    postings = np.sort(rng.integers(0, 5000, size=P)).astype(np.uint32)
    lens = rng.integers(1, max_len + 1, size=(B, L))
    lens[rng.random((B, L)) < empty] = 0
    offs = np.minimum(rng.integers(0, P, size=(B, L)), P - lens)
    return postings, offs.astype(np.int64), lens.astype(np.int64)


# (B, L, P, cap, longest slice, share of empty lanes, total - cum[:, -1]);
# the last two cases put cap past JAX's chunk of max(512, 2^24 // L)
# (1024 at L = 16384), so that JAX compares in three chunks
GATHER_CASES = {
    "cap above the totals": (3, 16, 200, 128, 9, 0.3, 0),
    "cap below some totals": (4, 16, 200, 24, 9, 0.3, 0),
    "odd postings length": (2, 16, 203, 96, 9, 0.5, 0),
    "total below cum": (2, 16, 201, 96, 9, 0.5, -3),
    "all lanes empty": (2, 8, 7, 16, 3, 1.0, 0),
    "three JAX chunks": (2, 16384, 5000, 2600, 3, 0.9, 0),
    "three JAX chunks, truncated": (2, 16384, 5000, 2100, 3, 0.85, 0),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_postings_equals_jax(case, weighted):
    B, L, P, cap, max_len, empty, delta = GATHER_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + weighted)
    postings, offs, lens = _slices(rng, B, L, P, max_len, empty)
    cum = np.cumsum(lens, axis=1)
    total = cum[:, -1] + delta
    wstart = rng.integers(1, 6, size=(B, L)) if weighted else None
    want = jax_count.gather_postings(
        jnp.asarray(postings), jnp.asarray(offs, jnp.int32),
        jnp.asarray(cum, jnp.int32), jnp.asarray(total, jnp.int32), cap,
        wstart=None if wstart is None else jnp.asarray(wstart, jnp.int32))
    got = count.gather_postings(
        _u32(postings), torch.from_numpy(offs), torch.from_numpy(cum),
        torch.from_numpy(total), cap,
        wstart=None if wstart is None else torch.from_numpy(wstart))
    assert len(got) == len(want) == (4 if weighted else 3)
    for g, w in zip(got, want):
        assert g.shape == (B, cap)
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    if case != "all lanes empty":
        assert got[2].any()


# ---------------------------------------------------------------------------
# member_bitmap
# ---------------------------------------------------------------------------


# (sets, B, K, L, longest set): test_engine.py:141's case, one hit a
# query, and a pool where most sets are empty
MEMBER_CASES = {"test_engine": (50, 6, 8, 16, 8), "K = 1": (50, 6, 1, 16, 8),
                "empty slices": (40, 4, 5, 12, 2)}


@pytest.mark.parametrize("case", list(MEMBER_CASES))
def test_member_bitmap_equals_jax_and_member_np(case):
    n_sets, B, K, L, longest = MEMBER_CASES[case]
    rng = np.random.default_rng(17)
    lens_sets = rng.integers(0, longest + 1, size=n_sets)
    if case == "empty slices":
        lens_sets[rng.random(n_sets) < 0.7] = 0
    postings = np.sort(rng.integers(0, 200, size=int(lens_sets.sum()))
                       .astype(np.uint32))
    starts = np.zeros(n_sets + 1, dtype=np.int64)
    np.cumsum(lens_sets, out=starts[1:])
    ids = rng.integers(0, n_sets, size=(B, L))
    offs, lens = starts[ids], starts[ids + 1] - starts[ids]
    hits = rng.integers(0, 200, size=(B, K)).astype(np.uint32)
    for b in range(B):  # a certain member a query, and the sentinel
        lanes = np.flatnonzero(lens[b])
        if lanes.size:
            hits[b, 0] = postings[offs[b, rng.choice(lanes)]]
    hits[-1, -1] = count.ROW_SENTINEL
    iters = int(np.ceil(np.log2(int(lens_sets.max()) + 1))) + 1
    want = np.asarray(jax_count.member_bitmap(
        jnp.asarray(postings), jnp.asarray(offs, jnp.int32),
        jnp.asarray(lens, jnp.int32), jnp.asarray(hits), iters))
    got = count.member_bitmap(_u32(postings), torch.from_numpy(offs),
                              torch.from_numpy(lens),
                              torch.from_numpy(hits.astype(np.int64)), iters)
    assert got.dtype == torch.bool and got.shape == (B, K, L)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(B):
        np.testing.assert_array_equal(
            got[b].numpy(), count.member_np(postings, offs[b], lens[b],
                                            hits[b]))
    assert want.any()


# ---------------------------------------------------------------------------
# sharded_search and replicate_query_batch
# ---------------------------------------------------------------------------


def _queries(shards, n):
    """n domain-skewed queries of the module's database (hot domains
    included), with one empty row."""
    seqs = shards["seqs"][: n - 4] + [
        shards["domains"][0] + shards["domains"][1],
        shards["domains"][2] * 2, shards["seqs"][5][:20], ""]
    return seqs, [max(len(q) - 6, 0) for q in seqs]


@pytest.fixture(scope="module")
def sharded_arrays(shards):  # noqa: F811
    g = shards["g"]
    return {n: (mesh.shard_index(load_db(g), n),
                jax_mesh.shard_index(jax_load_db(g), n)) for n in (2, 4)}


def test_replicate_query_batch_equals_jax(shards):  # noqa: F811
    seqs, sizes = _queries(shards, 13)
    for mult in (1, 8, 16):
        got = mesh.replicate_query_batch(seqs, sizes, mult)
        want = jax_mesh.replicate_query_batch(seqs, sizes, mult)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert mesh.replicate_query_batch([], [], 4)[0].shape == (4, 14)


@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("cap", [4096, 96])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_sharded_search_equals_jax(shards,  # noqa: F811
                                   sharded_arrays, grid, cap, positions):
    """make_sharded_search's outputs row for row -- counts, hit rows,
    totals and packed position bitmaps -- at a cap above every total and
    at one below some (both steps then drop the same entries)."""
    pm, jm = _meshes(grid)
    port_arr, jax_arr = sharded_arrays[GRIDS[grid][1]]
    seqs, sizes = _queries(shards, 32)
    codes, n_kmers = mesh.replicate_query_batch(seqs, sizes, 16)
    k = 16
    want = [np.asarray(o) for o in jax_mesh.make_sharded_search(
        jm, jax_arr.hash_log2, cap=cap, k=k, positions=positions)(
        jax_arr.tables, jax_arr.postings, codes, n_kmers)]
    got = mesh.sharded_search(*mesh.grid_index(port_arr, pm),
                              *mesh.grid_batch(codes, n_kmers, pm),
                              hash_log2=port_arr.hash_log2, cap=cap, k=k,
                              positions=positions)
    assert len(got) == len(want) == (4 if positions else 3)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy().astype(np.uint32), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert (want[2] > cap).any() == (cap < 4096)
    if positions:
        np.testing.assert_array_equal(got[3].numpy(), want[3])
        assert want[3].any()
    assert (want[0][:, 0] > 0).sum() > 20


@pytest.mark.parametrize("wire", ["codes7", "codes3"])
def test_sharded_search_wire_formats_equal_jax(shards,  # noqa: F811
                                               sharded_arrays, wire):
    """The step on wire words: pack_codes7's uint32 (held as int32 by the
    port) and pack_codes3's uint16, unpacked on every shard."""
    pm, jm = _meshes("1x4")
    port_arr, jax_arr = sharded_arrays[4]
    seqs, sizes = _queries(shards, 16)
    width = mesh._next_pow2(max(sizes)) + 6
    padded = codec.pad_codes_batch(seqs, width)
    packed = (codec.pack_codes7 if wire == "codes7"
              else codec.pack_codes3)(padded)
    n_kmers = np.asarray(sizes, np.int32)
    want = [np.asarray(o) for o in jax_mesh.make_sharded_search(
        jm, jax_arr.hash_log2, cap=2048, k=8, width=width, positions=True)(
        jax_arr.tables, jax_arr.postings, packed, n_kmers)]
    got = mesh.sharded_search(
        *mesh.grid_index(port_arr, pm),
        *mesh.grid_batch(packed, n_kmers, pm),
        hash_log2=port_arr.hash_log2, cap=2048, k=8, width=width,
        positions=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert want[3].any()


def test_sharded_search_matches_count_batch(shards):  # noqa: F811
    """test_parallel.py's yardstick on the port: at a cap above every
    total, each query's (row, count) list of the sharded step on a 2x4
    grid starts with the single-device engine's."""
    art = load_db(shards["g"])
    seqs, sizes = _queries(shards, 24)
    single = SearchEngine(art, "cpu").count_batch(seqs[:-1], sizes[:-1],
                                                  k=16)
    arrays = mesh.shard_index(art, 4)
    codes, n_kmers = mesh.replicate_query_batch(seqs, sizes, 8)
    grid = _meshes("2x4")[0]
    counts, hit_rows, totals = mesh.sharded_search(
        *mesh.grid_index(arrays, grid),
        *mesh.grid_batch(codes, n_kmers, grid),
        hash_log2=arrays.hash_log2, cap=1 << 12, k=32)
    assert int(totals.max()) <= 1 << 12
    for i, qc in enumerate(single):
        got = [(int(r), int(c)) for r, c in zip(hit_rows[i], counts[i])
               if c > 0]
        want = [(int(r), int(c)) for r, c in zip(qc.hit_rows, qc.counts)]
        assert want and got[: len(want)] == want, f"query {i}"
