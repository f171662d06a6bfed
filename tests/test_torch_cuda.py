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


@pytest.fixture(scope="module")
def probe_inputs():
    """Tables of 2^19 rows of 16, 32 and 64 B and 2^20 hashed row ids on
    the card, shared by the row_dma_probe cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    return ({w: _table1(1 << 19, w, dev) for w in (4, 8, 16)},
            pmb._hash_idx(1 << 20, 1 << 19, dev))


def _table1(n_rows, row_words, device):
    """The scripts' arange table plus one: word 0 of every row, row 0's
    included, is non-zero, so an output the kernel never wrote (the
    wrapper's zeroed uint32) cannot pass for the plain version's."""
    return pmb._table(n_rows, row_words, device) + 1


# every ring depth of the kernel's shape, n at one ring and either side of
# it, at the scripts' 4096 and at 2^20 copies (n = depth - 1 = 0 dropped)
DEPTH_N = [(d, n) for d in (1, 2, 7, 8, 16, 64)
           for n in sorted({1, d - 1, d, d + 1, 4096, 1 << 20} - {0})]


@pytest.mark.parametrize("slot0", [False, True])
@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("row_words", [8, 16])
@pytest.mark.parametrize("depth,n", DEPTH_N)
def test_row_dma_probe_matches_plain(probe_inputs, row_words, n, depth,
                                     stage, slot0):
    """P1-P3 (32 B rows, sum of word 0) and P6 (64 B rows, word 0 of row
    j0), with and without staged indices, exactly."""
    tables, idx = probe_inputs
    table = tables[row_words]
    before = pb.launches["row_dma_probe"]
    got = pb.row_dma_probe(table, idx, n, depth, stage, slot0)
    want = pb.row_dma_probe_plain(table, idx, n, depth, stage, slot0)
    assert torch.equal(got.cpu(), want.cpu())
    assert pb.launches["row_dma_probe"] == before + 1


def test_row_dma_probe_p1(cuda):
    """P1 as the script has it: one copy of row 7, checksum table[7, 0]."""
    kernel, _, args = pmb.v1_case(cuda)
    assert kernel(*args).item() == 7 * 8 == 56


@pytest.mark.parametrize("row_words,n_rows,n,depth", [
    (4, 1 << 19, 4096, 8),          # 16 B rows: 32 rows a warp step
    (4, 1 << 19, 1 << 20, 16),
    (12, 1 << 14, 100_003, 8),      # 48 B: 10 rows a step, 2 lanes idle
    (256, 1 << 12, 50_000, 4),      # 1 KB: one row a step, 2 chunks a lane
])
def test_row_dma_probe_other_widths(cuda, row_words, n_rows, n, depth):
    table = _table1(n_rows, row_words, cuda)
    idx = pmb._hash_idx(n, n_rows, cuda)
    for stage, slot0 in ((False, False), (True, True)):
        got = pb.row_dma_probe(table, idx, n, depth, stage, slot0)
        want = pb.row_dma_probe_plain(table, idx, n, depth, stage, slot0)
        assert torch.equal(got.cpu(), want.cpu())


def test_row_dma_probe_rejects_bad_rows(cuda):
    """Rows that are not 16-byte multiples raise before any launch; a
    warp's ring that does not fit in a block's shared memory raises from
    the entry point: 64 stages of 4 KB rows (2^20 copies give every warp
    more than 64 steps), or one 256 KB row."""
    idx = pmb._hash_idx(1 << 20, 1 << 10, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        pb.row_dma_probe(pmb._table(1 << 10, 6, cuda), idx, 4096, 8)
    with pytest.raises(RuntimeError, match="row_dma_probe failed"):
        pb.row_dma_probe(pmb._table(1 << 10, 1024, cuda), idx, 1 << 20, 64)
    with pytest.raises(RuntimeError, match="row_dma_probe failed"):
        pb.row_dma_probe(pmb._table(4, 1 << 16, cuda), idx[:8] % 4, 8, 1)


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
