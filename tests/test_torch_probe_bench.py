"""The probe microbenchmarks' torch port vs the JAX scripts
(scripts/pallas_dma_probe.py, scripts/probe_microbench.py) at reduced
sizes: each Pallas probe (P1-P6) runs in TPU interpret mode on the CPU,
each jnp experiment as jitted, and its checksum must equal the port's
plain-torch checksum exactly (integers)."""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kaamer_tpu_torch.bench import probe_microbench as tb

_table = tb._table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    """Import scripts/<name>.py, restoring the compilation cache directory
    that the script sets at import."""
    cache = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        spec = importlib.util.spec_from_file_location(
            f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_secs)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load_script("pallas_dma_probe"), _load_script("probe_microbench")


@pytest.fixture
def run_jax(monkeypatch):
    """Call a script function with its Pallas kernels in interpret mode and
    its timer replaced by one call; returns the checksum as uint32.
    `inputs`, where given, rewrites the arguments the script times its
    kernel on."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))

    def call(mod, fn, *args, inputs=None, **kw):
        got = []

        def fake_timed(f, *a, **_):
            if inputs is not None:
                a = inputs(*a)
            got.append(np.asarray(jax.device_get(f(*a))).reshape(-1))
            return 1.0

        monkeypatch.setattr(mod, "timed", fake_timed)
        fn(*args, **kw)
        assert len(got) == 1
        return int(got[0].view(np.uint32)[0])

    return call


def _port(fn, *args, **kw):
    checksum, seconds = fn("cpu", *args, **kw)
    assert seconds > 0
    return checksum & 0xFFFFFFFF


@pytest.mark.parametrize("name,kw", [
    ("v1_static_row_dma", {}),
    ("v2_dyn_row_dma", {"n_dmas": 48, "depth": 8}),
    ("v3_prefetch_dma", {"n_dmas": 40, "depth": 4}),
    ("v4_vmem_dyngather", {"T": 64, "inner": 3}),
])
def test_pallas_dma_probe(scripts, run_jax, monkeypatch, name, kw):
    """P1-P4 against the Pallas kernels in interpret mode."""
    mod = scripts[0]
    monkeypatch.setattr(mod, "N_ROWS", 1 << 10)
    monkeypatch.setattr(tb, "N_ROWS", 1 << 10)
    want = run_jax(mod, getattr(mod, name), **kw)
    assert _port(getattr(tb, name), **kw) == want


@pytest.mark.parametrize("name,kw", [
    ("pallas_dyngather_bench", {"T": 128, "inner_iters": 3}),
    ("pallas_dma_bench", {"n_dmas": 37, "depth": 1}),
    ("pallas_dma_bench", {"n_dmas": 37, "depth": 8}),
    ("pallas_dma_bench", {"n_dmas": 40, "depth": 16}),
])
def test_probe_microbench_pallas(scripts, run_jax, name, kw):
    """P5 and P6 (the slot-0 word at three ring depths)."""
    mod = scripts[1]
    want = run_jax(mod, getattr(mod, name), **kw)
    assert _port(getattr(tb, name), **kw) == want


@pytest.mark.parametrize("n_dmas", [3, 4, 5])
def test_p6_slot0_row_at_one_ring(scripts, run_jax, monkeypatch, n_dmas):
    """P6 at depth 4 with n = depth - 1, depth and depth + 1: the row the
    script's ring copies last into slot 0 is j0 = ((n - 1) // depth) *
    depth, here 0, 0 and 4.  Both sides run on the script's table plus
    one, so word 0 of every row is non-zero and an output never written
    (0) cannot pass.  At n < depth the script's prologue still starts
    `depth` copies and reads its index list past the end, which interpret
    mode refuses: the list is padded to `depth` entries, and the extra
    copies land in slots that no later read sees."""
    mod, depth = scripts[1], 4

    def inputs(idx, table):
        pad = np.zeros(max(0, depth - idx.shape[0]), np.int32)
        return np.concatenate([np.asarray(idx), pad]), table + 1

    monkeypatch.setattr(tb, "_table", lambda *a: _table(*a) + 1)
    want = run_jax(mod, mod.pallas_dma_bench, n_dmas=n_dmas, depth=depth,
                   inputs=inputs)
    row0 = (n_dmas - 1) // depth * depth * 2654435761 % (1 << 19)
    assert want == row0 * 16 + 1
    assert _port(tb.pallas_dma_bench, n_dmas=n_dmas, depth=depth) == want


@pytest.mark.parametrize("name,args", [
    ("gather_bench", (1 << 10, 8)),
    ("gather_bench", (1 << 12, 2)),
    ("windowed_gather_bench", (1 << 10, 6, 2)),
    ("windowed_gather_bench", (1 << 10, 12, 1)),
    ("sorted_gather_bench", (1 << 10, 6, "random")),
    ("sorted_gather_bench", (1 << 10, 6, "runs")),
    ("sorted_gather_bench", (1 << 10, 1, "sorted")),
    ("sort_bench", ("flat",)),
    ("sort_bench", ("pair",)),
    ("sort_bench", ("rows",)),
])
def test_probe_microbench_jnp(scripts, run_jax, monkeypatch, name, args):
    """E1, E5, E6 and E2 (jitted jnp in the script) at N = 2^13, or the
    script's fixed [2048, 256] for the row-wise sort."""
    mod = scripts[1]
    for m in (mod, tb):
        monkeypatch.setattr(m, "N", 1 << (19 if "rows" in args else 13))
        monkeypatch.setattr(m, "ITERS", 3)
    want = run_jax(mod, getattr(mod, name), *args)
    assert _port(getattr(tb, name), *args) == want


def test_probe_bench_entry_point_never_imports_jax():
    """The entry point runs and imports no jax (fresh interpreter: this
    process imports jax)."""
    code = ("import sys\n"
            "from kaamer_tpu_torch.bench import probe_microbench as b\n"
            "b.N_ROWS = 1 << 10\n"
            "assert b.main(['v3', '--device', 'cpu']) == 0\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert "v3 prefetch DMA depth=8: OK" in proc.stdout
