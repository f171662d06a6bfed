"""The hand-written CUDA kernels vs their plain torch versions on the card.

Imports no jax, so it also runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Without a CUDA device every test here skips (the kernels have no CPU
mode).  Exact equality: direction bytes, scores, paths, checksums and
counts are integers."""

import ctypes

import numpy as np
import pytest
import torch

from kaamer_tpu_torch.bench import probe_microbench as pmb
from kaamer_tpu_torch.ops import _kernels, hotset
from kaamer_tpu_torch.ops import count as ct
from kaamer_tpu_torch.ops.matrices import LETTER_INDEX, get_matrix_scores
from kaamer_tpu_torch.ops import probe_bench as pb
from kaamer_tpu_torch.ops import swalign_cuda as swc

AA = "ACDEFGHIKLMNPQRSTVWY"
SCORES = get_matrix_scores("blosum62", 11, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _tensors(pairs, device):
    codes = lambda s: LETTER_INDEX[np.frombuffer(s.encode(), np.uint8)]
    arrays = swc.pad_pairs([codes(q) for q, _ in pairs],
                           [codes(r) for _, r in pairs])
    mat = torch.from_numpy(SCORES.sub_matrix.astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays] + [mat.to(device)]


def _seq(rng, lo, hi):
    return "".join(rng.choice(list(AA), size=int(rng.integers(lo, hi + 1))))


def _batch(rng, n, lo, hi, device, r_lo=None, r_hi=None):
    """Half related pairs (point mutations, a deletion), half unrelated,
    plus a self alignment and a pair with no positive cell.  Query lengths
    lo..hi; unrelated references r_lo..r_hi (default the same)."""
    r_lo, r_hi = r_lo or lo, r_hi or hi
    pairs = [("WWWW", "PPPP"), ("MELPNIMHPVAKLSTAL", "MELPNIMHPVAKLSTAL")]
    for t in range(n):
        q = _seq(rng, lo, hi)
        r = list(q) if t % 2 == 0 and (r_lo, r_hi) == (lo, hi) else list(
            _seq(rng, r_lo, r_hi))
        for _ in range(len(r) // 12):
            r[int(rng.integers(0, len(r)))] = AA[int(rng.integers(0, 20))]
        if t % 2 == 0 and len(r) > 30:
            del r[10:18]
        pairs.append((q, "".join(r)))
    return _tensors(pairs, device)


def _assert_align_matches_plain(qc, rc, ql, rl, mat):
    """sw_align on the card == sw_traceback_plain(*sw_wavefront_plain) on
    the same card tensors: scores, lengths and the first n_ops ops."""
    before = swc.launches["sw_align"]
    got = [t.cpu() for t in swc.sw_align(qc, rc, ql, rl, mat, 11, 1)]
    assert swc.launches["sw_align"] == before + 1
    want = [t.cpu() for t in swc.sw_align_plain(qc, rc, ql, rl, mat, 11, 1)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for b, n in enumerate(got[3].tolist()):
        assert torch.equal(got[1][b, :n], want[1][b, :n])
        assert torch.equal(got[2][b, :n], want[2][b, :n])
    return got


@pytest.mark.parametrize("lo,hi", [(20, 300), (1500, 2048)])
def test_wavefront_and_traceback_match_plain(cuda, lo, hi):
    rng = np.random.default_rng(hi)
    got = _assert_align_matches_plain(*_batch(rng, 24, lo, hi, cuda))
    assert got[0][0] == 0 and got[0][1] > 0


@pytest.mark.parametrize("bucket", range(1, 17))
def test_sw_align_every_length_bucket(cuda, bucket):
    """Queries in each 128-bucket of pad_pairs (R = 4 .. 64 rows a lane;
    shared-memory directions in the short buckets, the global scratch in
    the long ones), from 30 residues up to 2047."""
    rng = np.random.default_rng(100 + bucket)
    lo, hi = max(30, 128 * (bucket - 1)), 128 * bucket - 1
    qc, rc, ql, rl, mat = _batch(rng, 10, lo, hi, cuda)
    assert swc.rows_per_lane(qc.shape[1]) == 4 * bucket
    _assert_align_matches_plain(qc, rc, ql, rl, mat)


@pytest.mark.parametrize("q_len,r_len", [((30, 60), (1800, 2048)),
                                         ((1800, 2048), (30, 60))])
def test_sw_align_skewed_shapes(cuda, q_len, r_len):
    """n >> m and m >> n, with a query of exactly 2048 residues in the
    second case (the m_pad = 2175 bucket, every row of R = 64 used)."""
    rng = np.random.default_rng(q_len[0])
    pairs = [(_seq(rng, *q_len), _seq(rng, *r_len)) for _ in range(8)]
    if q_len[1] == 2048:
        q = _seq(rng, 2048, 2048)
        pairs += [(q, q[1000:1060]), (q, q[1990:])]
    _assert_align_matches_plain(*_tensors(pairs, cuda))


@pytest.mark.parametrize("n,lo,hi,warps,use_smem", [
    (300, 20, 120, 3, 1), (600, 200, 250, 5, 1), (300, 480, 510, 3, 0)])
def test_sw_align_many_warps_a_block(cuda, n, lo, hi, warps, use_smem):
    """Batches wider than the H100's 132 SMs, so that a block holds several
    pairs (warps): directions in shared memory (R = 4 and R = 8), and in
    the global scratch (R = 16, where three pairs' directions overflow a
    block's 227 KB of shared memory)."""
    rng = np.random.default_rng(n + lo)
    qc, rc, ql, rl, mat = _batch(rng, n, lo, hi, cuda)
    plan = ctypes.c_int(0), ctypes.c_int(0)
    rc_ = _kernels.lib().kt_sw_align_plan(
        swc.rows_per_lane(qc.shape[1]), qc.shape[0], rc.shape[1],
        *map(ctypes.byref, plan))
    assert rc_ == 0 and [p.value for p in plan] == [warps, use_smem]
    _assert_align_matches_plain(qc, rc, ql, rl, mat)


def test_wrapper_rejects_bad_arguments(cuda):
    rng = np.random.default_rng(0)
    qc, rc, ql, rl, mat = _batch(rng, 4, 20, 40, cuda)
    with pytest.raises(ValueError):
        swc.sw_align(qc.int(), rc, ql, rl, mat, 11, 1)
    with pytest.raises(ValueError):
        swc.sw_align(qc, rc, ql, rl.cpu(), mat, 11, 1)
    with pytest.raises(ValueError):
        swc.sw_align(qc, rc[:, :8].contiguous(), ql, rl, mat, 11, 1)


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


def _dyngather_in_clusters(x, idx, T, inner, cluster):
    """smem_dyngather's kernel launched at `cluster` blocks a cluster
    through the entry kt_smem_dyngather_clusters (the wrapper launches the
    device's pick)."""
    out = torch.zeros(1, dtype=torch.int32, device=x.device)
    rc = _kernels.lib().kt_smem_dyngather_clusters(
        x.data_ptr(), idx.data_ptr(), T, inner, cluster, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "smem_dyngather")
    return out


@pytest.mark.parametrize("T", [1, 2, 32, 8192, 32768])
@pytest.mark.parametrize("inner", [0, 1, 33])
def test_smem_dyngather_random_indices(cuda, T, inner):
    """Uniformly random x and idx words (negative int32 included) at the
    edge table sizes (T = 1 and 2, one row of staging a block; T = 32768,
    four idx chunks) and round counts (none; one; 33, an unroll
    remainder), through the wrapper and at both cluster sizes the kernel
    launches (1 is the fallback of a card that cannot run 64 clusters of 2
    at once)."""
    rng = np.random.default_rng(T * 64 + inner)
    x, idx = (torch.from_numpy(rng.integers(-2**31, 2**31, size=(T, 128),
                                            dtype=np.int64).astype(np.int32))
              .to(cuda) for _ in range(2))
    want = pb.smem_dyngather_plain(x, idx, T, inner).cpu()
    assert torch.equal(pb.smem_dyngather(x, idx, T, inner).cpu(), want)
    for cluster in (1, 2):
        got = _dyngather_in_clusters(x, idx, T, inner, cluster)
        assert torch.equal(got.cpu(), want), cluster


def test_smem_dyngather_rejects_bad_clusters(cuda):
    """The entry launches clusters of 1 or 2 (0: the device's pick) and
    refuses any other size before a launch."""
    x = pmb._table(64, 128, cuda)
    idx = pmb._hash_idx(64 * 128, 64, cuda).reshape(64, 128)
    for cluster in (-1, 4, 8):
        with pytest.raises(RuntimeError, match="smem_dyngather failed"):
            _dyngather_in_clusters(x, idx, 64, 3, cluster)


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


def _sorted_keys(rng, G, n, rows, pad=0.2, zero_w=0.0, wmax=9):
    """sort_weighted's keys of random (row, weight) entries: rows below
    `rows`, a share `pad` of sentinels, a share `zero_w` of weight 0
    (injected candidates)."""
    r = rng.integers(0, rows, size=(G, n)).astype(np.int64)
    w = rng.integers(1, wmax, size=(G, n)).astype(np.int64)
    w[rng.random((G, n)) < zero_w] = 0
    r[rng.random((G, n)) < pad] = ct.ROW_SENTINEL
    return ct.sort_weighted(torch.from_numpy(r), torch.from_numpy(w))


def _rle_case(rng, case):
    if case == "random":
        return _sorted_keys(rng, 16, 5000, 300)
    if case == "one_run":  # each row a single run of one row value
        return _sorted_keys(rng, 4, 3000, 1, pad=0.0)
    if case == "tile_edges":  # runs of ~1000 entries across many steps
        return _sorted_keys(rng, 3, 12_000, 12, pad=0.1)
    if case == "all_sentinel":
        return _sorted_keys(rng, 5, 700, 10, pad=1.0)
    if case == "injected":  # zero-weight heads, as the TAM injects them
        return _sorted_keys(rng, 8, 2000, 200, zero_w=0.1)
    if case == "ragged":  # n a multiple of neither a lane nor a step
        return _sorted_keys(rng, 7, 1037, 50)
    if case == "one_long_row":
        return _sorted_keys(rng, 1, (1 << 21) + 64, 1 << 15)
    assert case == "many_short_rows"
    return _sorted_keys(rng, 2048, 64, 20, zero_w=0.05)


@pytest.mark.parametrize("case", ["random", "one_run", "tile_edges",
                                  "all_sentinel", "injected", "ragged",
                                  "one_long_row", "many_short_rows"])
def test_rle_sorted_matches_plain(cuda, case):
    """The rle_sorted kernel == rle_sorted_plain on the same card tensors,
    in both modes (rank keys with and without the injected heads)."""
    ks = _rle_case(np.random.default_rng(len(case)), case).to(cuda)
    for rank_keys, skip_inj in ((False, False), (True, False), (True, True)):
        before = ct.launches["rle_sorted"]
        got = ct.rle_sorted(ks, rank_keys, skip_inj)
        assert ct.launches["rle_sorted"] == before + 1
        want = ct.rle_sorted_plain(ks, rank_keys, skip_inj)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    torch.cuda.synchronize()


def test_rle_sorted_rejects_bad_arguments(cuda):
    ks = _sorted_keys(np.random.default_rng(0), 4, 100, 10).to(cuda)
    with pytest.raises(ValueError):
        ct.rle_sorted(ks.int())
    with pytest.raises(ValueError):
        ct.rle_sorted(ks.to("meta"))
    with pytest.raises(ValueError):
        ct.rle_sorted(ks.t())
    with pytest.raises(ValueError):
        ct.rle_sorted(ks[0])
