"""The port's twin of __graft_entry__.entry (__graft_entry__.py:19-94):
the single-device search step (encode -> hash-probe -> postings expand ->
sort/RLE -> top_k) on a small synthetic index built in memory, without
touching disk.

  search_step, args = entry("cuda")   # or "cpu"
  counts, hit_rows = search_step(*args)

search_step runs the engine's _phase1_impl and then _phase2_grouped_impl
(search/engine.py) at B = 16 queries of L = 128 k-mers, cap_s = 4096,
cap_t = 64 and k = 32, on the arguments (table, postings padded to a
multiple of 128, codes, n_kmers) as tensors on the device.  Returns
(counts int32[B, k], hit_rows int64[B, k]); the JAX step returns the same
rows as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import codec
from ..index.build import dedup_sets
from ..index.hashtable import build_table
from ..search.engine import _phase1_impl, _phase2_grouped_impl

B, L, CAP, K = 16, 128, 4096, 32
CAP_T = 64


def _synthetic_index(n_proteins=64, seq_len=80, seed=0):
    """A small in-memory index (cuckoo table + CSR postings) of uniformly
    random proteins: (table, set_offsets, postings, seqs)."""
    rng = np.random.default_rng(seed)
    aa = np.array(list(codec.AA_ALPHABET))
    seqs = ["".join(rng.choice(aa, size=seq_len)) for _ in range(n_proteins)]

    chunks = []
    for row, s in enumerate(seqs):
        kmers = codec.encode_kmers_np(codec.seq_to_codes(s))
        chunks.append((kmers.astype(np.uint64) << np.uint64(32)) | np.uint64(row))
    pairs = np.sort(np.concatenate(chunks))
    unique_kmers, set_ids, set_offsets, postings = dedup_sets(pairs)
    sid = set_ids.astype(np.int64)
    ht = build_table(unique_kmers,
                     set_offsets[sid].astype(np.uint32),
                     (set_offsets[sid + 1] - set_offsets[sid]).astype(np.uint32))
    return ht, set_offsets, postings, seqs


def _query_arrays(seqs, n_queries, L):
    """Residue codes int32[n_queries, L + 6] (-1 padded) and k-mer counts
    int32[n_queries] of seqs[i % len(seqs)]."""
    K = codec.KMER_SIZE
    codes = np.full((n_queries, L + K - 1), -1, dtype=np.int32)
    n_kmers = np.zeros(n_queries, dtype=np.int32)
    for i in range(n_queries):
        s = seqs[i % len(seqs)]
        c = codec.seq_to_codes(s)[: L + K - 1]
        codes[i, : c.shape[0]] = c
        n_kmers[i] = min(len(s) - K + 1, L)
    return codes, n_kmers


def entry(device="cuda", n_proteins: int = 64, queries=None):
    """(search_step, example_args) on `device`; a CUDA device without a
    card raises.  The index holds n_proteins random proteins of 80
    residues; the queries are its first B proteins, or `queries`
    (strings, one row each) when given."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"entry({device}): CUDA is not available (pass "
                           "'cpu' to run on the CPU)")
    ht, set_offsets, postings, seqs = _synthetic_index(n_proteins)
    # the table and postings hold uint32, viewed as int32 as the engine
    # keeps them (engine_state_from_artifact); postings padded to whole
    # 128-lane tiles for expand_hybrid's tile tier
    table = torch.from_numpy(np.ascontiguousarray(ht.table, np.uint32)
                             .view(np.int32)).to(device)
    pad = (-len(postings)) % 128
    postings = np.concatenate([postings.astype(np.uint32),
                               np.zeros(pad, np.uint32)])
    postings_dev = torch.from_numpy(postings.view(np.int32)).to(device)
    miss_start = int(set_offsets[-1])

    codes, n_kmers = _query_arrays(queries or seqs,
                                   len(queries) if queries else B, L)
    t_log2 = ht.log2

    def search_step(table, postings, codes, n_kmers):
        outs = _phase1_impl(table, codes, n_kmers, hash_log2=t_log2,
                            miss_start=miss_start)
        offs, cum_s, wstart = outs[0], outs[1], outs[2]
        cum_t, lens_l = outs[5], outs[6]
        # JAX passes run_start positionally after wstart
        # (kaamer_tpu/search/engine.py:1249); the port takes it as a
        # keyword, needed only with positions
        return _phase2_grouped_impl(postings, offs, cum_s, wstart, cum_t,
                                    lens_l, cap_s=CAP, cap_t=CAP_T, k=K,
                                    run_start=outs[3])

    # residue codes as int64: the 7-mer codes reach 2^32 (codec.encode_kmers)
    example_args = (
        table,
        postings_dev,
        torch.from_numpy(codes.astype(np.int64)).to(device),
        torch.from_numpy(n_kmers.astype(np.int64)).to(device),
    )
    return search_step, example_args
