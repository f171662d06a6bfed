"""The port's profiling harness (kaamer_tpu_torch.bench.harness) on -device
cpu against the JAX package's (kaamer_tpu.bench.harness): makedb writes
JAX's artifact bytes, monitor.out has JAX's line format, -trace writes a
torch.profiler Chrome trace, scaling prints JAX's record keys over 1, 2
and 4 shards, and the default device (cuda) fails without a card."""

import filecmp
import json
import os
import re

import numpy as np
import pytest
import torch

from kaamer_tpu.bench import harness as jax_harness
from kaamer_tpu_torch.bench import harness

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """60 proteins sharing 4 domains, a database built by the port's
    harness, and 4 queries."""
    rng = np.random.default_rng(12)
    tmp = tmp_path_factory.mktemp("torch_harness")
    doms = ["".join(rng.choice(list(AA), size=30)) for _ in range(4)]
    seqs = [doms[i % 4] + "".join(rng.choice(list(AA),
                                             size=int(rng.integers(20, 60))))
            for i in range(60)]
    (tmp / "in.fasta").write_text("".join(
        f">H{i} harness {i}\n{s}\n" for i, s in enumerate(seqs)))
    (tmp / "q.fasta").write_text("".join(
        f">q{i}\n{seqs[7 * i][:50]}\n" for i in range(4)))
    assert harness.main(["-func", "makedb", "-i", str(tmp / "in.fasta"),
                         "-d", str(tmp / "db"), "-monitor",
                         str(tmp / "make.out")]) == 0
    return tmp


def _lines(path):
    return [json.loads(ln) for ln in open(path)]


@pytest.mark.parametrize("noindex", [False, True], ids=["indexed", "noindex"])
def test_makedb_bytes_and_monitor_equal_jax(inputs, tmp_path, noindex):
    """makedb through each harness: the same artifact bytes, and monitor
    files of the same line format (samples {t, rss_bytes}, then one
    {MaxRSS_bytes})."""
    for name, mod in (("jax", jax_harness), ("torch", harness)):
        argv = ["-func", "makedb", "-i", str(inputs / "in.fasta"), "-d",
                str(tmp_path / name / "db"), "-monitor",
                str(tmp_path / f"{name}.out"), "-interval", "0.01"]
        assert mod.main(argv + ["-noindex"] * noindex) == 0
    names = sorted(os.listdir(tmp_path / "jax" / "db"))
    assert names == sorted(os.listdir(tmp_path / "torch" / "db"))
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax" / "db", tmp_path / "torch" / "db", names,
        shallow=False)
    assert not mismatch and not errors
    assert ("pairs.npy" in names) == noindex
    fmt = {}
    for name in ("jax", "torch"):
        lines = _lines(tmp_path / f"{name}.out")
        fmt[name] = ({tuple(ln) for ln in lines[:-1]}, tuple(lines[-1]))
        assert lines[-1]["MaxRSS_bytes"] == max(
            ln["rss_bytes"] for ln in lines[:-1])
    assert fmt["torch"] == fmt["jax"] == ({("t", "rss_bytes")},
                                          ("MaxRSS_bytes",))


def test_opendb_and_search_trace(inputs, tmp_path, capsys):
    """opendb and search -trace on the CPU: the trace is a Chrome trace
    of the search (its events include the engine's torch ops)."""
    db = str(inputs / "db")
    mon = ["-monitor", str(tmp_path / "m.out"), "-device", "cpu"]
    assert harness.main(["-func", "opendb", "-d", db] + mon) == 0
    out = capsys.readouterr().out
    assert "opendb: " in out and ", 60 proteins, " in out
    assert harness.main(["-func", "search", "-d", db, "-i",
                         str(inputs / "q.fasta"), "-trace",
                         str(tmp_path / "trace")] + mon) == 0
    out = capsys.readouterr().out
    path = tmp_path / "trace" / harness.TRACE_FILE
    assert f"device trace written to {path}" in out
    rows = int(re.search(r"search: [0-9.]+s, (\d+) result rows", out)[1])
    assert rows > 4
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert _lines(tmp_path / "m.out")[-1].keys() == {"MaxRSS_bytes"}


def test_scaling_prints_jax_keys(inputs, tmp_path, capsys):
    """scaling over 1, 2 and 4 CPU shards prints one record a mesh with
    the keys of the JAX harness's records (on its 8 virtual devices)."""
    db = str(inputs / "db")
    mon = ["-monitor", str(tmp_path / "m.out")]
    assert jax_harness.main(["-func", "scaling", "-d", db] + mon) == 0
    want = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert harness.main(["-func", "scaling", "-d", db, "-device", "cpu"]
                        + mon) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert [r["n_shards"] for r in got] == [1, 2, 4]
    assert [r["n_shards"] for r in want] == [1, 2, 4, 8]
    assert {tuple(r) for r in got} == {tuple(r) for r in want}
    assert all(r["platform"] == "cpu" and r["queries_per_s"] > 0
               for r in got)


@pytest.mark.parametrize("func", ["opendb", "search", "scaling"])
def test_default_device_needs_a_card(inputs, tmp_path, func):
    """Without -device cpu the harness runs on cuda, and with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.main(["-func", func, "-d", str(inputs / "db"), "-i",
                      str(inputs / "q.fasta"), "-monitor",
                      str(tmp_path / "m.out")])
