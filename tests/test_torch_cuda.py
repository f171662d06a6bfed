"""The hand-written CUDA kernels vs their plain torch versions on the card.

Imports no jax, so it also runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA device every test here skips (the kernels have no CPU
mode).  Exact equality: direction bytes, scores and paths are integers."""

import numpy as np
import pytest
import torch

from kaamer_tpu.ops.matrices import LETTER_INDEX, get_matrix_scores
from kaamer_tpu_torch.ops import swalign_cuda as swc

AA = "ACDEFGHIKLMNPQRSTVWY"
SCORES = get_matrix_scores("blosum62", 11, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _batch(rng, n, lo, hi, device):
    """Half related pairs (point mutations, a deletion), half unrelated,
    plus a self alignment and a pair with no positive cell."""
    pairs = [("WWWW", "PPPP"), ("MELPNIMHPVAKLSTAL", "MELPNIMHPVAKLSTAL")]
    for t in range(n):
        q = "".join(rng.choice(list(AA), size=int(rng.integers(lo, hi))))
        r = list(q) if t % 2 == 0 else list(
            rng.choice(list(AA), size=int(rng.integers(lo, hi))))
        for _ in range(len(r) // 12):
            r[int(rng.integers(0, len(r)))] = AA[int(rng.integers(0, 20))]
        if t % 2 == 0 and len(r) > 30:
            del r[10:18]
        pairs.append((q, "".join(r)))
    codes = lambda s: LETTER_INDEX[np.frombuffer(s.encode(), np.uint8)]
    arrays = swc.pad_pairs([codes(q) for q, _ in pairs],
                           [codes(r) for _, r in pairs])
    mat = torch.from_numpy(SCORES.sub_matrix.astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays] + [mat.to(device)]


@pytest.mark.parametrize("lo,hi", [(20, 300), (1500, 2049)])
def test_wavefront_and_traceback_match_plain(cuda, lo, hi):
    rng = np.random.default_rng(hi)
    qc, rc, ql, rl, mat = _batch(rng, 24, lo, hi, cuda)
    dirs, best = swc.sw_wavefront(qc, rc, ql, rl, mat, 11, 1)
    p_dirs, p_best = swc.sw_wavefront_plain(qc, rc, ql, rl, mat, 11, 1)
    B, d_pad, W = dirs.shape
    d = torch.arange(d_pad, device=cuda)[None, :, None]
    i = torch.arange(W, device=cuda)[None, None, :]
    q = ql.long()[:, None, None]
    r = rl.long()[:, None, None]
    valid = (i >= 1) & (i <= q) & (d - i >= 1) & (d - i <= r)
    assert torch.equal(dirs[valid], p_dirs[valid])
    lanes = torch.arange(W, device=cuda)[None, :] <= ql.long()[:, None]
    for c in (0, 1):
        assert torch.equal(best[:, c][lanes], p_best[:, c][lanes])

    got = [t.cpu() for t in swc.sw_traceback(dirs, best, ql)]
    want = [t.cpu() for t in swc.sw_traceback_plain(dirs, best, ql)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for b, n in enumerate(got[3].tolist()):
        assert torch.equal(got[1][b, :n], want[1][b, :n])
        assert torch.equal(got[2][b, :n], want[2][b, :n])
    assert got[0][0] == 0 and got[0][1] > 0
    assert swc.launches["sw_wavefront"] > 0 and swc.launches["sw_traceback"] > 0


def test_wrapper_rejects_bad_arguments(cuda):
    rng = np.random.default_rng(0)
    qc, rc, ql, rl, mat = _batch(rng, 4, 20, 40, cuda)
    with pytest.raises(ValueError):
        swc.sw_wavefront(qc.int(), rc, ql, rl, mat, 11, 1)
    with pytest.raises(ValueError):
        swc.sw_wavefront(qc, rc, ql, rl.cpu(), mat, 11, 1)
    with pytest.raises(ValueError):
        swc.sw_wavefront(qc, rc[:, :8].contiguous(), ql, rl, mat, 11, 1)
