"""The hand-written CUDA kernels vs their plain torch versions on the card.

Imports no jax, so it also runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA device every test here skips (the kernels have no CPU
mode).  Exact equality: direction bytes, scores, paths, checksums and
counts are integers."""

import numpy as np
import pytest
import torch

from kaamer_tpu.ops.matrices import LETTER_INDEX, get_matrix_scores
from kaamer_tpu_torch.bench import probe_microbench as pmb
from kaamer_tpu_torch.ops import hotset
from kaamer_tpu_torch.ops import probe_bench as pb
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


@pytest.mark.parametrize("row_words,n,depth,stage,slot0", [
    (8, 1, 1, False, False),        # P1
    (8, 4096, 8, False, False),     # P2
    (8, 4096, 8, True, False),      # P3
    (16, 4096, 1, True, True),      # P6 at the scripts' three depths
    (16, 4096, 8, True, True),
    (16, 4096, 16, True, True),
    (16, 1000, 16, True, True),     # n not a multiple of depth
])
def test_row_dma_probe_matches_plain(cuda, row_words, n, depth, stage, slot0):
    table = pmb._table(1 << 19, row_words, cuda)
    idx = pmb._hash_idx(n, 1 << 19, cuda)
    if n == 1:
        idx.fill_(7)
    before = pb.launches["row_dma_probe"]
    got = pb.row_dma_probe(table, idx, n, depth, stage, slot0)
    want = pb.row_dma_probe_plain(table, idx, n, depth, stage, slot0)
    assert torch.equal(got.cpu(), want.cpu())
    assert pb.launches["row_dma_probe"] == before + 1


@pytest.mark.parametrize("T,inner", [(512, 32), (4096, 32), (8192, 32),
                                     (8192, 3)])
def test_smem_dyngather_matches_plain(cuda, T, inner):
    """P4/P5 at the scripts' table sizes."""
    x = pmb._table(T, 128, cuda)
    idx = pmb._hash_idx(T * 128, T, cuda).reshape(T, 128)
    got = pb.smem_dyngather(x, idx, T, inner)
    want = pb.smem_dyngather_plain(x, idx, T, inner)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("L", [256, 512])
def test_hot_matmul_exact_on_card(cuda, L):
    """W @ M on the card with counts above 256 at L = 512 (the hi/lo
    split, float32 output) and the engine's bf16 form at L = 256, against
    an int64 reference."""
    rng = np.random.default_rng(L)
    G, H, P = 64, 96, 4096
    M = (rng.random((H, P)) < 0.3).astype(np.int64)
    W = np.zeros((G, H), np.int64)
    for g in range(G):  # each query's weights sum to <= L, as in the engine
        h = rng.choice(H, size=8, replace=False)
        W[g, h] = rng.multinomial(L - int(rng.integers(0, 8)), [1 / 8] * 8)
    ref = W @ M
    assert (ref.max() > 256) == (L > 256)
    out = hotset.hot_matmul(
        torch.from_numpy(W).float().to(cuda),
        torch.from_numpy(M).to(torch.bfloat16).to(cuda), max_w=L,
        out_dtype=torch.bfloat16 if L <= 256 else torch.float32)
    np.testing.assert_array_equal(out.float().cpu().numpy().astype(np.int64),
                                  ref)
