"""Whole runs of the harness on the CPU (its look for a card skipped):
the last line, the numbers compared beside their limits, the control
and planted faults coming out not correct, and no JAX module loaded."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import control

from .conftest import BENCH, ROOT, TRAFFIC, last_json, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("workload", ["tiny-proteome", "tiny-reads"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(cache_root, tiny_db, workload, trace):
    rc, out, err = run_cell(workload, 2**31 + 99, cache_root, trace=trace)
    assert rc == 0, "\n".join(err[-30:])
    res = last_json(out)
    assert set(res) == KEYS | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    from benchmark import registry
    cell = registry.cell(workload, BENCH, TRAFFIC)
    want = cell.per_layer if trace else cell.end_to_end
    # the CPU has no device operations to read a roofline from
    assert set(res["metrics"]) == {m["name"] for m in want}
    for m in want:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    if trace:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    checks = [l for l in err if l.startswith("check ")]
    assert err[-len(res["checks"]):] == checks
    for name, c in res["checks"].items():
        assert f"check {name}: {c['value']} (limit {c['limit']})" in checks


@pytest.mark.parametrize("fault", ["alter_answers", "drop_half"])
@pytest.mark.parametrize("workload", ["tiny-proteome", "tiny-reads"])
def test_a_planted_fault_is_not_correct(cache_root, tiny_db, workload,
                                        fault):
    rc, out, err = run_cell(workload, 5, cache_root,
                            plant=f"benchmark.tests.faults:{fault}")
    assert rc == 0, "\n".join(err[-30:])
    res = last_json(out)
    assert res["correct"] is False
    assert res["checks"]["queries_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", ["tiny-proteome", "tiny-reads"])
def test_the_control_is_not_correct(cache_root, tiny_db, workload, capsys):
    control.main(["--workload", workload, "--seeds", "1,2,3",
                  "--requests", "2"], bench_path=BENCH, traffic_dir=TRAFFIC,
                 cache_root=cache_root)
    lines = [l for l in capsys.readouterr().out.splitlines() if l]
    import json
    got = [json.loads(l) for l in lines]
    assert len(got) == 3
    assert all(g["correct"] is False for g in got)
    assert min(g["checks"]["queries_wrong"]["value"] for g in got) > 0


def test_no_jax_module_in_a_run(cache_root, tiny_db):
    code = (
        "import sys\n"
        "from benchmark import run\n"
        f"rc = run.main(['--workload', 'tiny-reads', '--seed', '1', "
        f"'--seconds', '1'], bench_path={BENCH!r}, traffic_dir={TRAFFIC!r},"
        f" cache_root={cache_root!r}, device='cpu')\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print('FORBIDDEN', sorted(tops & {'jax', 'jaxlib', 'flax', "
        "'kaamer_tpu'}))\n"
        "print('PORT', 'kaamer_tpu_torch' in tops)\n"
        "sys.exit(rc)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout and "PORT True" in p.stdout


def test_the_reference_and_clients_import_nothing_of_the_program():
    here = os.path.join(ROOT, "benchmark")
    own = ("reference", "records", "loops", "generators")
    files = [p for d in own
             for p in glob.glob(os.path.join(here, d, "*.py"))] + [
        os.path.join(here, f) for f in ("client.py", "generate.py",
                                        "database.py", "tracefile.py",
                                        "host.py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        names = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"jax", "jaxlib", "flax", "kaamer_tpu"}, path
        if os.path.basename(os.path.dirname(path)) in own \
                or path.endswith(("client.py", "generate.py", "host.py")):
            assert "kaamer_tpu_torch" not in tops, path
            assert "torch" not in tops, path


def test_fails_without_the_program(tmp_path, cache_root, tiny_db):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the run ends with an error and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    rc, out, err = run_cell("tiny-proteome", 1, str(tmp_path / "c"),
                            cwd=str(tmp_path),
                            bench=str(tmp_path / "benchmark/tests/data/"
                                      "bench.json"),
                            traffic=str(tmp_path / "benchmark/tests/data/"
                                        "traffic"))
    assert rc != 0
    assert not any(l.startswith("{") for l in out)
