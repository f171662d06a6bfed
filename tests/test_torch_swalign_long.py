"""-aln at every length a database holds: per-pair routing, one launch a
flush, and the kernel's strips of 32R query rows.

On the CPU: align_batch (the plain version) on a flush that mixes short
pairs with pairs of 2,049-4,096 residues equals the host DP pair by pair,
through result_from_ops; only a pair past MAX_LEN reaches the host DP; the
strip layout of the kernel's directions (pack_dirs_nibbles,
sw_walk_nibbles_plain) walks back to the plain traceback's paths; a
flush's device pairs go in one launch, padded to its longest pair.  With a CUDA card, sw_align against
its plain version at those lengths and on a mixed flush (imports no jax:
`python -m pytest tests/test_torch_swalign_long.py -q --noconftest`)."""

import numpy as np
import pytest
import torch

from kaamer_tpu_torch.ops import swalign as tsw
from kaamer_tpu_torch.ops import swalign_cuda as swc
from kaamer_tpu_torch.ops.matrices import LETTER_INDEX, get_matrix_scores
from kaamer_tpu_torch.records import KStats

AA = "ACDEFGHIKLMNPQRSTVWY"
SCORES = get_matrix_scores("blosum62", 11, 1)
STATS = KStats(NumberOfAA=316_000_000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _seq(rng, n):
    return "".join(rng.choice(list(AA), size=int(n)))


def _mutated(rng, s, rate=0.08, cut=None):
    """s with point mutations and one deletion; a window of it if cut."""
    m = list(s if cut is None else s[cut[0]:cut[1]])
    for _ in range(int(len(m) * rate)):
        m[int(rng.integers(0, len(m)))] = AA[int(rng.integers(0, 20))]
    if len(m) > 60:
        del m[20:27]
    return "".join(m)


def _mixed_flush(rng):
    """Short pairs of 30-400 residues, related and not, around pairs of
    2,049-4,096: a long query against a window of itself, a short query
    against a long reference holding it, two long related proteins whose
    alignment crosses query row 2048, and a 4,096-residue query."""
    pairs = []
    for t in range(10):
        q = _seq(rng, rng.integers(30, 401))
        pairs.append((q, _mutated(rng, q) if t % 2 == 0
                      else _seq(rng, rng.integers(30, 401))))
    q = _seq(rng, 2049)
    pairs.insert(3, (q, _mutated(rng, q, cut=(1900, 2049))))
    r = _seq(rng, 4096)
    pairs.insert(6, (_mutated(rng, r, cut=(3700, 3950)), r))
    q = _seq(rng, 2600)
    pairs.insert(8, (q, _mutated(rng, q, cut=(1500, 2600))))
    q = _seq(rng, 4096)
    pairs.append((q, _mutated(rng, q, cut=(4000, 4096))))
    return pairs


def _host(q, r):
    codes = lambda s: LETTER_INDEX[np.frombuffer(s.encode(), np.uint8)]
    _, q_ops, r_ops = tsw._smith_waterman(codes(q), codes(r),
                                          SCORES.sub_matrix, SCORES.gap_open,
                                          SCORES.gap_extend)
    return tsw.result_from_ops(q, r, SCORES, q_ops, r_ops, STATS)


def test_mixed_flush_equals_host_dp_field_for_field():
    rng = np.random.default_rng(2049)
    pairs = _mixed_flush(rng)
    before = tsw.HOST_DP_PAIRS
    handle = tsw.align_batch_dispatch(pairs, STATS, "blosum62", 11, 1,
                                      device="cpu")
    counts = handle[-1]
    got = tsw.align_batch_resolve(handle)
    assert tsw.HOST_DP_PAIRS == before
    assert counts["aln_pairs"] == counts["aln_device_pairs"] == len(pairs)
    assert counts["aln_host_pairs"] == 0
    assert counts["aln_launches"] == 1
    assert handle[3][0] == list(range(len(pairs)))
    assert counts["aln_cells"] == sum(len(q) * len(r) for q, r in pairs)
    assert counts["aln_padded_cells"] > counts["aln_cells"]
    for (q, r), g in zip(pairs, got):
        assert g == _host(q, r)
    crossing = got[8]
    assert crossing.QueryStart <= 2048 < crossing.QueryEnd
    assert got[-1].QueryEnd == 4096 and got[6].SubjectEnd > 3900


def test_host_dp_pairs_counts_only_pairs_past_the_limit():
    rng = np.random.default_rng(8193)
    short = [(_seq(rng, 60), _seq(rng, 80)) for _ in range(3)]
    q = _seq(rng, 40)
    past = _seq(rng, 100) + q + _seq(rng, swc.MAX_LEN + 1 - 140)
    edge = _seq(rng, swc.MAX_LEN)
    pairs = short + [(q, past), (edge[:30], edge)]
    before = tsw.HOST_DP_PAIRS
    handle = tsw.align_batch_dispatch(pairs, STATS, "blosum62", 11, 1,
                                      device="cpu")
    assert handle[4] == [3]
    assert (handle[-1]["aln_host_pairs"], handle[-1]["aln_device_pairs"]) \
        == (1, 4)
    got = tsw.align_batch_resolve(handle)
    assert tsw.HOST_DP_PAIRS == before + 1
    assert got[3] == _host(q, past) and got[3].SubjectStart == 101
    assert got[4] == _host(*pairs[4])


def _layout_pairs(rng, rows):
    """Random and related pairs with queries up to `rows` residues, and
    ties across strips: one motif at the top of the query and again past
    row `rows` - 60 (the lowest i must win), a motif twice in the
    reference (the first j), and a plateau of one residue."""
    pairs = [("WWWW", "PPPP")]
    for _ in range(4):
        q = _seq(rng, rng.integers(rows // 2, rows + 1))
        pairs.append((q, _mutated(rng, q, cut=(len(q) // 3, len(q)))))
        pairs.append((q, _seq(rng, rng.integers(20, 150))))
    a = _seq(rng, 15)
    pairs += [(a + _seq(rng, rows - 60) + a + _seq(rng, 15), a),
              (a, a + _seq(rng, 40) + a), ("W" * rows, "W" * 37)]
    return pairs


@pytest.mark.parametrize("R,rows", [(4, 300), (8, 700), (4, 520)])
def test_strip_layout_walks_back_to_the_same_paths(R, rows):
    """Queries of two to six strips of 32R rows: the kernel's strip layout
    and its key over every strip give sw_traceback_plain's paths."""
    rng = np.random.default_rng(R * rows)
    pairs = _layout_pairs(rng, rows)
    codes = lambda s: LETTER_INDEX[np.frombuffer(s.encode(), np.uint8)]
    arrays = swc.pad_pairs([codes(q) for q, _ in pairs],
                           [codes(r) for _, r in pairs])
    qc, rc, ql, rl = (torch.from_numpy(x) for x in arrays)
    mat = torch.from_numpy(SCORES.sub_matrix.astype(np.int32))
    dirs, best = swc.sw_wavefront_plain(qc, rc, ql, rl, mat, 11, 1)
    want = swc.sw_traceback_plain(dirs, best, ql)
    words = swc.pack_dirs_nibbles(dirs, ql, rl, R)
    n_strips = swc.strips(R, int(ql.max()))
    assert n_strips >= 2
    assert words.shape[1:] == (n_strips * (int(rl.max()) + 31),
                               (R + 7) // 8, 32)
    got = swc.sw_walk_nibbles_plain(words, best, ql, R, dirs.shape[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tie = len(pairs) - 3
    n = int(want[3][tie])
    assert int(want[1][tie, 0]) == 0 and n == 15  # the top copy of the motif


def test_one_launch_takes_every_device_pair(monkeypatch):
    """A batch's pairs within MAX_LEN go in one launch, in batch order,
    padded to the longest of them (R = 64 and two strips for a 3,885-residue
    query); its padded cells are 32R rows a strip each query takes, times
    its reference's length; the pair past MAX_LEN is left out."""
    rng = np.random.default_rng(5)
    lens = ([(int(m), int(n)) for m, n in rng.integers(30, 700, (40, 2))]
            + [(2049, 300), (300, 3885), (3885, 3885), (2100, 90),
               (swc.MAX_LEN + 1, 50), (127, 128), (126, 129)])
    pairs = [(_seq(rng, m), _seq(rng, n)) for m, n in lens]
    seen = []

    def fake(qcodes, rcodes, qlens, rlens, mat, go, ge, **kw):
        seen.append((qcodes.shape[1], rcodes.shape[1], qlens.tolist(),
                     rlens.tolist()))
        B, d = qcodes.shape[0], swc._d_pad(qcodes.shape[1], rcodes.shape[1])
        return (torch.zeros(B, dtype=torch.int32),
                torch.zeros((B, d), dtype=torch.int16),
                torch.zeros((B, d), dtype=torch.int16),
                torch.zeros(B, dtype=torch.int32))
    monkeypatch.setattr(swc, "sw_align", fake)
    handle = tsw.align_batch_dispatch(pairs, STATS, "blosum62", 11, 1,
                                      device="cpu")
    dev = [b for b, (m, _) in enumerate(lens) if m <= swc.MAX_LEN]
    assert handle[3][0] == dev and handle[4] == [44]
    assert len(seen) == handle[-1]["aln_launches"] == 1
    m_pad, n_pad, qls, rls = seen[0]
    assert (m_pad, n_pad) == swc.padded(3885, 3885)
    assert qls == [lens[b][0] for b in dev] and rls == [lens[b][1]
                                                        for b in dev]
    R = swc.rows_per_lane(m_pad)
    assert R == 64 and swc.strips(R, m_pad) == 2
    assert handle[-1]["aln_cells"] == sum(m * n for m, n in zip(qls, rls))
    assert handle[-1]["aln_padded_cells"] == sum(
        32 * R * swc.strips(R, m) * n for m, n in zip(qls, rls))


def _tensors(pairs, device):
    codes = lambda s: LETTER_INDEX[np.frombuffer(s.encode(), np.uint8)]
    arrays = swc.pad_pairs([codes(q) for q, _ in pairs],
                           [codes(r) for _, r in pairs])
    mat = torch.from_numpy(SCORES.sub_matrix.astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays] + [mat.to(device)]


def _assert_kernel_matches_plain(qc, rc, ql, rl, mat):
    got = [t.cpu() for t in swc.sw_align(qc, rc, ql, rl, mat, 11, 1)]
    want = [t.cpu() for t in swc.sw_align_plain(qc, rc, ql, rl, mat, 11, 1)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for b, n in enumerate(got[3].tolist()):
        assert torch.equal(got[1][b, :n], want[1][b, :n])
        assert torch.equal(got[2][b, :n], want[2][b, :n])
    return got


@pytest.mark.parametrize("q_lo,q_hi,r_lo,r_hi", [
    (2049, 2300, 100, 400), (3000, 4096, 2500, 4096), (60, 300, 3800, 4096),
    (4096, 4096, 4096, 4096)])
def test_sw_align_past_2048_matches_plain(cuda, q_lo, q_hi, r_lo, r_hi):
    """Two strips of 2,048 rows (R = 64) and references of up to 4,096
    columns on the card, against the plain version on the same tensors."""
    rng = np.random.default_rng(q_lo + r_hi)
    pairs = []
    for t in range(4):
        q = _seq(rng, rng.integers(q_lo, q_hi + 1))
        n = int(rng.integers(r_lo, r_hi + 1))
        r = (_mutated(rng, q)[:n] if t % 2 == 0 else _seq(rng, n))
        pairs.append((q, r if r else _seq(rng, n)))
    got = _assert_kernel_matches_plain(*_tensors(pairs, cuda))
    assert int(got[0].min()) > 0


def test_sw_align_strips_of_small_r(cuda):
    """The strip arithmetic at R = 4 (strips of 128 rows): kt_sw_align
    takes R as given, so a 700-residue query runs in six strips."""
    import ctypes

    from kaamer_tpu_torch.ops import _kernels

    rng = np.random.default_rng(700)
    pairs = _layout_pairs(rng, 700)
    qc, rc, ql, rl, mat = _tensors(pairs, cuda)
    B, m_pad = qc.shape
    n_pad = rc.shape[1]
    d_pad = swc._d_pad(m_pad, n_pad)
    lib = _kernels.lib()
    out = [torch.empty(B, dtype=torch.int32, device=cuda),
           torch.empty((B, d_pad), dtype=torch.int16, device=cuda),
           torch.empty((B, d_pad), dtype=torch.int16, device=cuda),
           torch.empty(B, dtype=torch.int32, device=cuda)]
    scratch = torch.empty(B * lib.kt_sw_align_pair_bytes(4, m_pad, n_pad),
                          dtype=torch.uint8, device=cuda)
    rc_ = lib.kt_sw_align(
        qc.data_ptr(), rc.data_ptr(), ql.data_ptr(), rl.data_ptr(),
        mat.data_ptr(), B, m_pad, n_pad, d_pad, 4, 11, 1, 0, 2,
        scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), out[3].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc_ == 0
    assert lib.kt_sw_align(
        qc.data_ptr(), rc.data_ptr(), ql.data_ptr(), rl.data_ptr(),
        mat.data_ptr(), B, m_pad, n_pad, d_pad, 4, 11, 1, 1, 2,
        None, *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream) != 0  # no strips in smem
    want = [t.cpu() for t in swc.sw_align_plain(qc, rc, ql, rl, mat, 11, 1)]
    got = [t.cpu() for t in out]
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    for b, n in enumerate(got[3].tolist()):
        assert torch.equal(got[1][b, :n], want[1][b, :n])
        assert torch.equal(got[2][b, :n], want[2][b, :n])


def test_align_batch_mixed_flush_on_the_card(cuda):
    """The mixed flush through align_batch on the card: every pair on the
    device, in one launch, equal to the host DP field for field."""
    rng = np.random.default_rng(4096)
    pairs = _mixed_flush(rng)
    before = swc.launches["sw_align"]
    handle = tsw.align_batch_dispatch(pairs, STATS, "blosum62", 11, 1,
                                      device=cuda)
    got = tsw.align_batch_resolve(handle)
    assert handle[4] == [] and handle[3][0] == list(range(len(pairs)))
    assert swc.launches["sw_align"] == before + 1
    for (q, r), g in zip(pairs, got):
        assert g == _host(q, r)


def test_plain_blocks_equal_the_plain_ops_on_the_whole_batch():
    """sw_align_plain runs its wavefront and traceback in blocks of like
    padded length; its outputs, and sw_align's on the CPU, equal one
    wavefront and traceback over the whole batch, ops past n_ops -1
    included."""
    rng = np.random.default_rng(12)
    pairs = [(_seq(rng, rng.integers(5, 300)), _seq(rng, rng.integers(5, 300)))
             for _ in range(9)]
    q = _seq(rng, 700)
    pairs[4] = (q, _mutated(rng, q, cut=(100, 400)))
    pairs[7] = (_seq(rng, 40), q)
    qc, rc, ql, rl, mat = _tensors(pairs, "cpu")
    want = swc.sw_traceback_plain(*swc.sw_wavefront_plain(
        qc, rc, ql, rl, mat, 11, 1), ql)
    for got in (swc.sw_align_plain(qc, rc, ql, rl, mat, 11, 1),
                swc.sw_align(qc, rc, ql, rl, mat, 11, 1)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert int(want[0][4]) > 0


def test_bit_score_of_1024_or_more_gives_evalue_zero():
    """A self-hit of 700 residues scores past 2^1024 in E-value's
    denominator: the E-value is 0, as Go's math.Pow (+Inf) gives."""
    q = _seq(np.random.default_rng(700), 700)
    got = tsw.align_batch([(q, q)], STATS, device="cpu")[0]
    assert got.BitScore >= 1024 and got.EValue == 0.0
    assert got == _host(q, q)


def _profiled(fn, tmp_path):
    """fn() under a CPU profiler of every thread; (its result, the names
    of the `kaamer.align` spans it recorded)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU], experimental_config=(
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e["name"] for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e["name"].startswith("kaamer.align")]


def test_aln_search_opens_its_spans_and_counts(tmp_path):
    """-aln through run_search under a profiler: one dispatch and one
    resolve span a flush, one kernel span a launch whose name carries its
    real and padded cells and bytes (the counters' sums), the same bytes
    as without the profiler, and engine.stats counting every pair on the
    device."""
    from kaamer_tpu_torch.index.artifact import load_db
    from kaamer_tpu_torch.index.build import build_db
    from kaamer_tpu_torch.search.engine import SearchEngine
    from kaamer_tpu_torch.search.options import PROTEIN
    from kaamer_tpu_torch.search.pipeline import run_search
    from kaamer_tpu_torch.server.app import _default_options

    rng = np.random.default_rng(31)
    doms = [_seq(rng, rng.integers(25, 45)) for _ in range(6)]
    seqs = ["".join(doms[int(d)] + _seq(rng, rng.integers(5, 30))
                    for d in rng.integers(0, 6, size=int(rng.integers(1, 5))))
            for _ in range(40)]
    with open(tmp_path / "db.fasta", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">SP{i:04d} protein {i}\n{s}\n")
    build_db(str(tmp_path / "db"), str(tmp_path / "db.fasta"), "fasta")
    engine = SearchEngine(load_db(str(tmp_path / "db")), "cpu")
    with open(tmp_path / "q.fasta", "w") as f:
        for i in range(6):
            f.write(f">q{i}\n{_mutated(rng, seqs[i], rate=0.03)}\n")
    opts = _default_options(PROTEIN)
    opts.File, opts.Align, opts.MaxResults = str(tmp_path / "q.fasta"), \
        True, 5
    before = dict(engine.stats)
    want = b"".join(run_search(engine, opts))
    stats = {k: engine.stats[k] - before[k] for k in tsw.ALIGN_COUNTS}
    got, names = _profiled(lambda: b"".join(run_search(engine, opts)),
                           tmp_path)
    assert got == want
    rows = want.count(b"\n") - 1
    assert stats["aln_pairs"] == stats["aln_device_pairs"] == rows > 6
    assert stats["aln_host_pairs"] == 0
    flushes = names.count("kaamer.align.dispatch")
    assert flushes == names.count("kaamer.align.resolve") >= 1
    kernels = [n.split(":")[1:] for n in names
               if n.startswith("kaamer.align.kernel:")]
    assert len(kernels) == stats["aln_launches"]
    assert sum(int(c) for c, _, _ in kernels) == stats["aln_cells"]
    assert sum(int(p) for _, p, _ in kernels) == stats["aln_padded_cells"]
    assert all(int(b) > 0 for _, _, b in kernels)
