"""CPU tests of the benchmark (a tiny seed-77 database served on the CPU).

    python -m pytest benchmark/tests -q

Tests marked `card` need a CUDA card; they decide in a fixture and skip
without one."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(HERE, "data")
BENCH = os.path.join(DATA, "bench.json")
TRAFFIC = os.path.join(DATA, "traffic")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on "
                    "one")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture(scope="session")
def tiny_db(cache_root):
    from benchmark import database, registry

    cell = registry.cell("tiny-proteome", BENCH, TRAFFIC)
    return database.ensure(cell.config, cache_root, log=lambda *a: None)


def run_cell(workload, seed, cache_root, trace=0, seconds=2, device="cpu",
             plant=None, cwd=ROOT, bench=BENCH, traffic=TRAFFIC):
    """One run of the harness in a fresh process; (returncode, stdout
    lines, stderr lines).  plant: "module:function" applied to the engine
    after its warmup."""
    kw = dict(bench_path=bench, traffic_dir=traffic, cache_root=cache_root,
              device=device)
    code = (
        "import importlib, json, sys\n"
        "from benchmark import run\n"
        f"kw = json.loads({json.dumps(json.dumps(kw))})\n"
        f"plant = {plant!r}\n"
        "if plant:\n"
        "    mod, fn = plant.split(':')\n"
        "    kw['plant'] = getattr(importlib.import_module(mod), fn)\n"
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], **kw))\n")
    env = dict(os.environ, PYTHONPATH=cwd)
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    return p.returncode, p.stdout.splitlines(), p.stderr.splitlines()


def last_json(lines):
    return json.loads(lines[-1])
