"""Subprocess driver for test_torch_multihost.py: one process of a
2-process torch.distributed (gloo) job serving the port's
ShardedSearchEngine.  Imports no jax.

Each process holds a (1, 4) grid of "cpu" devices; the process group
makes the dp axis 2 across processes (global_mesh), so each process runs
the sharded steps of its half of every batch and group.  Every process
replays the same host schedule from the dp-gathered phase-1 totals and
reads the dp-gathered group outputs, so the result stream must be
byte-identical in both processes and to a single-process run.

Usage: python mh_torch_engine_driver.py <out.bin> <db_dir> <queries.fasta>
(with KAAMER_COORDINATOR, KAAMER_NUM_PROCESSES, KAAMER_PROCESS_ID set)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from kaamer_tpu_torch.index.artifact import load_db  # noqa: E402
from kaamer_tpu_torch.parallel.dist import (ShardedSearchEngine,  # noqa: E402
                                            global_mesh, init_distributed)
from kaamer_tpu_torch.search.options import PROTEIN, SearchOptions  # noqa: E402
from kaamer_tpu_torch.search.pipeline import run_search  # noqa: E402

init_distributed()
assert dist.get_world_size() == 2, dist.get_world_size()
mesh = global_mesh(devices=["cpu"] * 4)
assert mesh.shape == {"dp": 2, "shard": 4}, mesh.shape
engine = ShardedSearchEngine(load_db(sys.argv[2]), mesh)
assert engine.hot_starts is not None  # the hot matmul path is exercised

opts = SearchOptions(File=sys.argv[3], SequenceType=PROTEIN,
                     OutFormat="tsv", ExtractPositions=True)
buf = b"".join(run_search(engine, opts))
with open(sys.argv[1], "wb") as f:
    f.write(buf)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                         "kaamer_tpu"))
assert not bad, bad
print(f"p{dist.get_rank()} OK {len(buf)}B {engine.stats}", flush=True)
dist.destroy_process_group()
