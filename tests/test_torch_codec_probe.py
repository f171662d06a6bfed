"""Torch port vs JAX: wire unpack, 7-mer encode and the cuckoo probe.
Exact equality: every output is an integer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaamer_tpu import codec
from kaamer_tpu.index.hashtable import (EMPTY_KEY, HASH_MULT, HASH_MULT2,
                                        bucket_of, build_table)
from kaamer_tpu.ops.probe import probe_slices as probe_jax
from kaamer_tpu_torch import codec as tcodec
from kaamer_tpu_torch.ops.probe import probe_slices as probe_torch

AA = "ACDEFGHIKLMNPQRSTVWYUXB"  # 'X', 'B' fall outside the 21-letter alphabet


def _random_codes(rng, B, width):
    seqs = ["".join(rng.choice(list(AA), size=int(rng.integers(0, width + 1))))
            for _ in range(B)]
    return codec.pad_codes_batch(seqs, width)


@pytest.mark.parametrize("width", [7, 13, 70, 262])
def test_unpack_codes7_and_encode_kmers(width):
    rng = np.random.default_rng(width)
    codes = _random_codes(rng, 9, width)
    wire = codec.pack_codes7(codes)

    want = np.asarray(codec.unpack_codes7_jnp(jnp.asarray(wire), width))
    got = tcodec.unpack_codes7(torch.from_numpy(wire.view(np.int32)), width)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)  # pads come back -1

    n = width - 6
    want_k = np.asarray(jax.vmap(lambda c: codec.encode_kmers_jnp(c, n))(
        jnp.asarray(want, dtype=jnp.int32)))
    got_k = tcodec.encode_kmers(got, n)
    np.testing.assert_array_equal(got_k.numpy(), want_k.astype(np.int64))


def _both(table, log2, queries, miss):
    ws, wl = probe_jax(jnp.asarray(table), jnp.asarray(queries), log2, miss)
    gs, gl = probe_torch(torch.from_numpy(table.view(np.int32)),
                         torch.from_numpy(queries.astype(np.int64)), log2, miss)
    return (np.asarray(ws).astype(np.int64), np.asarray(wl).astype(np.int64),
            gs.numpy(), gl.numpy())


def test_probe_hits_misses_and_padding():
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 2**32 - 1, size=3000, dtype=np.uint64)
                     ).astype(np.uint32)
    starts = np.cumsum(rng.integers(1, 50, size=keys.size)).astype(np.uint32)
    lens = rng.integers(1, 50, size=keys.size).astype(np.uint32)
    ht = build_table(keys, starts, lens)
    miss = int(starts[-1]) + 100
    absent = rng.integers(0, 2**32 - 1, size=500, dtype=np.uint64
                          ).astype(np.uint32)
    absent = absent[~np.isin(absent, keys)]
    queries = np.concatenate([rng.choice(keys, 700), absent,
                              keys[:3], keys[-3:]]).reshape(1, -1)
    ws, wl, gs, gl = _both(ht.table, ht.log2, queries, miss)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gl, wl)
    assert (gs == miss).any() and (gl > 0).any()


def test_probe_key_whose_two_hashes_coincide():
    """h1(q) == h2(q) gathers one row twice; the hit must count once."""
    rng = np.random.default_rng(5)
    log2 = 3
    cand = rng.integers(0, 2**32 - 1, size=4000, dtype=np.uint64
                        ).astype(np.uint32)
    same = cand[bucket_of(cand, log2, HASH_MULT)
                == bucket_of(cand, log2, HASH_MULT2)]
    other = cand[bucket_of(cand, log2, HASH_MULT)
                 != bucket_of(cand, log2, HASH_MULT2)]
    q_same, q_other = same[0], other[0]
    table = np.full((1 << log2, 6), EMPTY_KEY, dtype=np.uint32)
    table[bucket_of(np.array([q_same]), log2, HASH_MULT)[0], 0:3] = (
        q_same, 40, 7)
    table[bucket_of(np.array([q_other]), log2, HASH_MULT2)[0], 3:6] = (
        q_other, 90, 3)
    queries = np.array([q_same, q_other, same[1], other[1]], dtype=np.uint32)
    ws, wl, gs, gl = _both(table, log2, queries, 1000)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gl, wl)
    assert gs.tolist() == [40, 90, 1000, 1000]
    assert gl.tolist() == [7, 3, 0, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_kmer_helpers_match_jax(seed):
    """encode_kmer, decode_kmer and query_num_kmers equal the JAX package's
    on random 7-mers and queries, characters outside the alphabet and a
    trailing '*' included."""
    rng = np.random.default_rng(seed)
    letters = list(AA + "*")
    for _ in range(200):
        kmer = "".join(rng.choice(list(AA), size=7))
        value = codec.encode_kmer(kmer)
        assert tcodec.encode_kmer(kmer) == value
        assert tcodec.decode_kmer(value) == codec.decode_kmer(value)
        query = "".join(rng.choice(letters, size=int(rng.integers(0, 40))))
        assert tcodec.query_num_kmers(query) == codec.query_num_kmers(query)
    assert tcodec.query_num_kmers("ACDEFGHI*") == codec.query_num_kmers(
        "ACDEFGHI*") == 2


def test_parse_fasta_bytes_matches_jax():
    """The port's native FASTA scanner gives the JAX package's buffers,
    offsets and headers (CRLF, blank lines, lower case, spaces, an empty
    record)."""
    from kaamer_tpu import native as jnative
    from kaamer_tpu_torch import native as tnative

    rng = np.random.default_rng(3)
    records = [b">P1 first protein\nMELPni mhpv\nAKLS\n",
               b">P2 second\r\nMELPNIM\n\n", b">empty\n"]
    for i in range(40):
        seq = "".join(rng.choice(list(AA.lower() + AA), size=90)).encode()
        records.append(b">Q%d some header\n%s\n%s\n" % (i, seq[:60], seq[60:]))
    data = b"".join(records)
    want = jnative.parse_fasta_bytes(data)
    got = tnative.parse_fasta_bytes(data)
    assert (got is None) == (want is None) and tnative.available()
    np.testing.assert_array_equal(got[1], want[1])
    # the buffer past the last offset is never written
    np.testing.assert_array_equal(got[0][:got[1][-1]], want[0][:want[1][-1]])
    assert got[2] == want[2] and len(got[2]) == 43
