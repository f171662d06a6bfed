"""The port's sharded engine across two processes: the twin of
test_multihost.py's production-engine test on torch.distributed (gloo).
Both processes, each a (1, 4) grid of "cpu" devices joined along dp,
serve a shard-built artifact and must stream the bytes of a
single-process (2, 4) grid, and of each other."""

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
# seconds a driver process may take; past it the test fails (the driver
# is killed), the suite goes on
DRIVER_TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_engine_streams_identical_bytes(tmp_path):
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

    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, outs = [], []
    for pid in (0, 1):
        outs.append(str(tmp_path / f"p{pid}.bin"))
        env = dict(os.environ, KAAMER_COORDINATOR=f"localhost:{port}",
                   KAAMER_NUM_PROCESSES="2", KAAMER_PROCESS_ID=str(pid),
                   PYTHONPATH=repo, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, DRIVER, outs[-1], dbdir, qfasta], env=env,
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

    engine = ShardedSearchEngine(load_db(dbdir), [["cpu"] * 4] * 2)
    assert engine.hot_starts is not None
    want = b"".join(run_search(engine, SearchOptions(
        File=qfasta, SequenceType=PROTEIN, OutFormat="tsv",
        ExtractPositions=True)))
    assert want.count(b"\n") > 24  # real hit rows, not just the header
    got0, got1 = (open(o, "rb").read() for o in outs)
    assert got0 == got1, "processes diverged"
    assert got0 == want, "two-process stream != single-process stream"
