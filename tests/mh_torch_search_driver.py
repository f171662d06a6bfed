"""Subprocess driver for test_torch_multihost.py: one process of a
2-process torch.distributed (gloo) job running the port's whole-batch
sharded search step (parallel/mesh.sharded_search), the twin of
mh_driver.py.  Imports no jax.

Each process holds a (1, 4) grid of "cpu" devices; the process group
makes the dp axis 2 across processes (global_mesh), so each process
runs the step on its dp row's half of the batch and saves its rows, with
their first global row, to an .npz for the parent to check against a
single-process run.

Usage: python mh_torch_search_driver.py <out.npz>
(with KAAMER_COORDINATOR, KAAMER_NUM_PROCESSES, KAAMER_PROCESS_ID set)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from kaamer_tpu_torch.bench.entry import (_query_arrays,  # noqa: E402
                                          _synthetic_index)
from kaamer_tpu_torch.parallel.dist import (global_mesh,  # noqa: E402
                                            init_distributed)
from kaamer_tpu_torch.parallel.mesh import (grid_batch,  # noqa: E402
                                            grid_index,
                                            shard_index_arrays,
                                            sharded_search)

B, L, CAP, K = 16, 64, 1024, 16

init_distributed()
assert dist.get_world_size() == 2, dist.get_world_size()
mesh = global_mesh(devices=["cpu"] * 4)
assert mesh.shape == {"dp": 2, "shard": 4}, mesh.shape

ht, set_offsets, postings, seqs = _synthetic_index()
sharded = shard_index_arrays(ht.table, set_offsets, postings, n_shards=4)
codes, n_kmers = _query_arrays(seqs, B, L)
counts, hit_rows, totals, bits = sharded_search(
    *grid_index(sharded, mesh), *grid_batch(codes, n_kmers, mesh),
    hash_log2=sharded.hash_log2, cap=CAP, k=K, positions=True)
np.savez(sys.argv[1], row_start=dist.get_rank() * (B // 2),
         counts=counts.numpy(), hit_rows=hit_rows.numpy(),
         totals=totals.numpy(), bits=bits.numpy())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                         "kaamer_tpu"))
assert not bad, bad
print(f"p{dist.get_rank()} OK", flush=True)
dist.destroy_process_group()
