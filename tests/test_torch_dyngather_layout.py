"""smem_dyngather's shared-memory layout, mirrored in numpy
(kaamer_tpu_torch/ops/probe_bench.py), and its bank-conflict model.

The kernel (csrc/probe_bench.cu) cannot run here; what decides its speed
is where each word of a column lies in shared memory and which rows the 32
lanes of a warp gather for.  These tests hold the mirror to the kernel's
constants and the layout to the model: the slot map is a bijection, and on
the scripts' inputs (scripts/pallas_dma_probe.py:194) a warp gather costs
no more wavefronts than uniformly random indices do, where the first
port's layout cost 32."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kaamer_tpu_torch.bench import probe_microbench as pmb
from kaamer_tpu_torch.ops import probe_bench as pb

SOURCE = (Path(pb.__file__).parents[1] / "csrc" / "probe_bench.cu").read_text()
ROUNDS = 3


def _script_idx(T):
    return pmb._hash_idx(T * 128, T, "cpu").reshape(T, 128).numpy()


def _random_idx(T, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, size=(T, 128), dtype=np.int64)


def test_mirror_states_the_kernels_constants():
    """DG_THREADS and DG_CHUNK are the kernel's, and dyngather_slot is its
    dg_slot expression."""
    const = dict(re.findall(r"constexpr int (kDg\w+) = (\d+);", SOURCE))
    assert int(const["kDgThreads"]) == pb.DG_THREADS
    assert int(const["kDgChunk"]) == pb.DG_CHUNK
    assert "return a ^ (((a >> 5) ^ (a >> 10)) & 31u);" in SOURCE


@pytest.mark.parametrize("T", [1, 2, 32, 512, 4096, 8192, 32768])
def test_slot_map_is_a_bijection(T):
    a = np.arange(T, dtype=np.int64)
    slots = pb.dyngather_slot(a)
    np.testing.assert_array_equal(np.sort(slots), a)
    # runs of 32 consecutive words (the staging stores) keep 32 banks
    if T >= 32:
        banks = (slots.reshape(-1, 32) & 31)
        assert (np.sort(banks, axis=1) == np.arange(32)).all()


@pytest.mark.parametrize("T", [1, 2, 32, 512, 4096, 8192, 32768])
def test_warps_cover_each_row_once(T):
    """Every row of a column is gathered by exactly one lane, and each
    warp's lanes hold consecutive rows of one chunk."""
    rows = pb.dyngather_warp_rows(T)
    live = rows[rows >= 0]
    np.testing.assert_array_equal(np.sort(live), np.arange(T))
    for w in rows:
        w = w[w >= 0]
        assert len(w) and (np.diff(w) == 1).all()
        assert w[0] // pb.DG_CHUNK == w[-1] // pb.DG_CHUNK


@pytest.mark.parametrize("T", [4096, 8192])
def test_scripts_inputs_cost_no_more_than_random(T):
    """The swizzled layout brings the scripts' inputs to at most the
    random-index level (3.52 wavefronts a warp gather at T = 8192), and
    random indices stay there."""
    new = pb.dyngather_wavefronts(_script_idx(T), T, ROUNDS)
    rand = pb.dyngather_wavefronts(_random_idx(T, T), T, ROUNDS)
    assert 3.4 < rand < 3.6
    assert new <= min(rand, 3.6)


@pytest.mark.parametrize("T", [4096, 8192])
def test_first_layout_models_at_32(T):
    """The diagnosis: word a at slot a puts all 32 lanes of a warp in one
    bank at every round of the scripts' inputs."""
    assert pb.dyngather_wavefronts(_script_idx(T), T, ROUNDS,
                                   swizzle=False) == 32.0


def test_wavefront_model_counts_broadcasts_once():
    """One word read by every lane is one wavefront; 32 words of one bank
    are 32; 32 consecutive words are 1; idle lanes read nothing."""
    T = 1024
    same = np.zeros((T, 128), np.int64)
    assert pb.dyngather_wavefronts(same, T, 1, swizzle=False) == 1.0
    stride = np.tile((np.arange(T) * 32 % T)[:, None], (1, 128))
    assert pb.dyngather_wavefronts(stride, T, 1, swizzle=False) == 32.0
    seq = np.tile(np.arange(T)[:, None], (1, 128))
    assert pb.dyngather_wavefronts(seq, T, 1) == 1.0
    assert pb.dyngather_wavefronts(same[:1], 1, 1) == 1.0
    assert pb.dyngather_wavefronts(same, T, 0) == 0.0


def test_wrapper_checks_its_arguments():
    """inner < 0 raises on any device; on the CPU the wrapper is the plain
    version."""
    x = torch.arange(64 * 128, dtype=torch.int32).reshape(64, 128)
    idx = torch.from_numpy(_random_idx(64, 1).astype(np.int32))
    with pytest.raises(ValueError):
        pb.smem_dyngather(x, idx, 64, -1)
    assert torch.equal(pb.smem_dyngather(x, idx, 64, 5),
                       pb.smem_dyngather_plain(x, idx, 64, 5))
    assert pb.smem_dyngather(x, idx, 64, 0).item() == 0
