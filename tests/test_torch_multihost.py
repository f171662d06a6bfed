"""The port's sharded engine across two processes: the twins of
test_multihost.py's tests on torch.distributed (gloo).  Both processes,
each a (1, 4) grid of "cpu" devices joined along dp, serve a shard-built
artifact and must stream the bytes of a single-process (2, 4) grid, and
of each other; also after both ran the same ShardedSearchEngine.warmup
grid.  And the whole-batch sharded search step: each process's rows must
equal a single-process (2, 4) grid's and JAX's make_sharded_search's."""

import os
import socket
import subprocess
import sys

import numpy as np

from kaamer_tpu.index.build import build_db
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.parallel.dist import ShardedSearchEngine
from kaamer_tpu_torch.search.options import PROTEIN, SearchOptions
from kaamer_tpu_torch.search.pipeline import run_search

DRIVER = os.path.join(os.path.dirname(__file__), "mh_torch_engine_driver.py")
SEARCH_DRIVER = os.path.join(os.path.dirname(__file__),
                             "mh_torch_search_driver.py")
# seconds a driver process may take; past it the test fails (the driver
# is killed), the suite goes on
DRIVER_TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_engine_streams_identical_bytes(tmp_path):
    _two_process_run(tmp_path, [DRIVER])


# mh_torch_engine_driver.py with every ShardedSearchEngine warmed as it
# is built: both processes run the same grid in the same order (their
# group steps join the dp gathers), which must leave stats at zero
WARMED = f"""
import runpy, sys
from kaamer_tpu_torch.parallel import dist
init = dist.ShardedSearchEngine.__init__
def warmed(self, *a, **kw):
    init(self, *a, **kw)
    self.warmup(batch_sizes=(16,), lengths=(16, 32), positions=(False, True),
                caps=(64, 128))
    assert self.stats == {{"cold": 0, "hot": 0}}, self.stats
dist.ShardedSearchEngine.__init__ = warmed
sys.argv[0] = {DRIVER!r}
runpy.run_path({DRIVER!r}, run_name="__main__")
"""


def test_two_process_warmup_then_identical_bytes(tmp_path):
    """Both processes warm the same grid, then stream the single-process
    bytes."""
    _two_process_run(tmp_path, ["-c", WARMED])


def test_two_process_sharded_search_matches_single_process(tmp_path):
    """sharded_search with positions on two processes joined along dp:
    each one's rows equal the same rows of one process's (2, 4) grid,
    and of JAX's step on global_mesh(4) of the conftest's devices."""
    import jax.numpy as jnp

    from kaamer_tpu.parallel.dist import global_mesh as jax_global_mesh
    from kaamer_tpu.parallel.mesh import make_sharded_search
    from kaamer_tpu_torch.bench.entry import _query_arrays, _synthetic_index
    from kaamer_tpu_torch.parallel.dist import Mesh
    from kaamer_tpu_torch.parallel.mesh import (grid_batch, grid_index,
                                                shard_index_arrays,
                                                sharded_search)

    outs = _spawn(tmp_path, [SEARCH_DRIVER], "npz")
    ht, set_offsets, postings, seqs = _synthetic_index()
    sharded = shard_index_arrays(ht.table, set_offsets, postings, n_shards=4)
    codes, n_kmers = _query_arrays(seqs, 16, 64)
    grid = Mesh([["cpu"] * 4] * 2)
    single = [t.numpy() for t in sharded_search(
        *grid_index(sharded, grid), *grid_batch(codes, n_kmers, grid),
        hash_log2=sharded.hash_log2, cap=1024, k=16, positions=True)]
    want = [np.asarray(a) for a in make_sharded_search(
        jax_global_mesh(4), sharded.hash_log2, cap=1024, k=16,
        positions=True)(sharded.tables, sharded.postings,
                        jnp.asarray(codes), jnp.asarray(n_kmers))]
    for s, w in zip(single, want):
        np.testing.assert_array_equal(s.astype(np.int64), w.astype(np.int64))
    assert (want[0][:, 0] > 0).all() and want[3].any()
    seen = set()
    for out in outs:
        z = np.load(out)
        lo = int(z["row_start"])
        for name, s in zip(("counts", "hit_rows", "totals", "bits"), single):
            n = z[name].shape[0]
            np.testing.assert_array_equal(z[name], s[lo:lo + n], name)
        seen.update(range(lo, lo + n))
    assert seen == set(range(16))  # both processes' halves covered


def _spawn(tmp_path, program, ext, args=()):
    """Runs program (argv after the interpreter) in two processes of one
    gloo job, each with its output path first; fails unless both exit 0
    within DRIVER_TIMEOUT.  Returns the output paths."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, outs = [], []
    for pid in (0, 1):
        outs.append(str(tmp_path / f"p{pid}.{ext}"))
        env = dict(os.environ, KAAMER_COORDINATOR=f"localhost:{port}",
                   KAAMER_NUM_PROCESSES="2", KAAMER_PROCESS_ID=str(pid),
                   PYTHONPATH=repo, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, *program, outs[-1], *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fails = []
    for pid, p in enumerate(procs):
        try:
            stdout, _ = p.communicate(timeout=DRIVER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            stdout, _ = p.communicate()
            fails.append((pid, "timeout", stdout.decode()[-2000:]))
            continue
        if p.returncode != 0:
            fails.append((pid, p.returncode, stdout.decode()[-2000:]))
    for p in procs:
        p.wait()
    assert not fails, fails
    return outs


def _two_process_run(tmp_path, program):
    rng = np.random.default_rng(21)
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    doms = ["".join(rng.choice(aa, size=int(rng.integers(18, 40))))
            for _ in range(8)]
    seqs = []
    for _ in range(220):
        parts = [doms[j] for j in range(8) if rng.random() < 1.0 / (j + 2)]
        parts.append("".join(rng.choice(aa, size=int(rng.integers(20, 50)))))
        seqs.append("".join(parts))
    with open(tmp_path / "db.fasta", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">MH{i:05d} multihost\n{s}\n")
    dbdir = str(tmp_path / "db")
    build_db(dbdir, str(tmp_path / "db.fasta"), "fasta", n_shards=4)
    qfasta = str(tmp_path / "q.fasta")
    with open(qfasta, "w") as f:
        for i in range(24):
            s = seqs[(i * 7) % len(seqs)]
            f.write(f">q{i}\n{s[: max(12, len(s) // 2)]}\n")

    outs = _spawn(tmp_path, program, "bin", (dbdir, qfasta))

    engine = ShardedSearchEngine(load_db(dbdir), [["cpu"] * 4] * 2)
    assert engine.hot_starts is not None
    want = b"".join(run_search(engine, SearchOptions(
        File=qfasta, SequenceType=PROTEIN, OutFormat="tsv",
        ExtractPositions=True)))
    assert want.count(b"\n") > 24  # real hit rows, not just the header
    got0, got1 = (open(o, "rb").read() for o in outs)
    assert got0 == got1, "processes diverged"
    assert got0 == want, "two-process stream != single-process stream"
