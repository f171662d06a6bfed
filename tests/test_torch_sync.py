"""The port's dispatch paths only enqueue work: no device-to-host read in
sw_batch_dispatch or SearchEngine.dispatch_batch, exactly one (the totals)
in schedule_batch; pair lengths are checked on the host before any device
work, with the device check's verdict; a substitution matrix is uploaded
once per (device, matrix, gaps).  On the CPU a read is any call that
would wait for a card: Tensor.cpu, .item, .tolist and conversion to a
Python bool or int.  chip_smoke.py proves the same on the card under
torch.cuda.set_sync_debug_mode."""

import contextlib

import numpy as np
import pytest
import torch

from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.index.build import build_db
from kaamer_tpu_torch.ops import swalign as sw
from kaamer_tpu_torch.ops import swalign_cuda as swc
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.upload import _stage, _views, upload_all

AA = "ACDEFGHIKLMNPQRSTVWY"
SCORES = sw.get_matrix_scores("blosum62", 11, 1)
READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__index__")


@contextlib.contextmanager
def count_reads():
    """Count the tensor methods in READS called inside the block."""
    n = {"reads": 0}
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def wrap(name):
        def f(self, *a, **kw):
            n["reads"] += 1
            return saved[name](self, *a, **kw)
        return f

    try:
        for name in READS:
            setattr(torch.Tensor, name, wrap(name))
        yield n
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _pairs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(sw._codes("".join(rng.choice(list(AA), size=m))),
             sw._codes("".join(rng.choice(list(AA), size=n))))
            for m, n in lengths]


def _stub_plain(monkeypatch):
    """sw_align's CPU path without its DP: zero scores of the right
    shapes (these tests check what happens before the DP)."""
    calls = []

    def plain(qc, rc, ql, rl, mat, go, ge):
        calls.append(mat)
        B, d = qc.shape[0], swc._d_pad(qc.shape[1], rc.shape[1])
        z = torch.zeros(B, dtype=torch.int32)
        return z, torch.zeros((B, d), dtype=torch.int16), \
            torch.zeros((B, d), dtype=torch.int16), z
    monkeypatch.setattr(swc, "sw_align_plain", plain)
    return calls


def test_sw_batch_dispatch_reads_nothing(monkeypatch):
    _stub_plain(monkeypatch)
    pairs = _pairs([(40, 60), (250, 240), (90, 30), (7, 9)])
    with count_reads() as n:
        handle = swc.sw_batch_dispatch([q for q, _ in pairs],
                                       [r for _, r in pairs], SCORES, "cpu")
    assert n["reads"] == 0
    assert len(swc.sw_batch_resolve(handle)) == 4


@pytest.mark.parametrize("q_len,r_len", [
    (2047, 2048), (2048, 2048), (2049, 100), (100, 2049), (2049, 2049),
    (1, 1)])
def test_host_length_check_matches_device_check(q_len, r_len, monkeypatch):
    """sw_batch_dispatch checks the pad_pairs lengths on the host and
    raises before any upload or launch; its verdict is sw_align's own
    (device-side) check on the same padded batch."""
    calls = _stub_plain(monkeypatch)
    uploads = []
    monkeypatch.setattr(swc, "upload_all",
                        lambda arrays, d: uploads.append(arrays)
                        or upload_all(arrays, d))
    qs, rs = zip(*_pairs([(q_len, r_len), (30, 30)]))
    try:
        swc.sw_batch_dispatch(list(qs), list(rs), SCORES, "cpu")
        host_ok = True
    except ValueError as e:
        host_ok = False
        assert "exceed" in str(e) and not uploads and not calls
    arrays = [torch.from_numpy(a) for a in swc.pad_pairs(list(qs), list(rs))]
    mat = torch.from_numpy(SCORES.sub_matrix.astype(np.int32))
    try:
        swc.sw_align(*arrays, mat, 11, 1)
        device_ok = True
    except ValueError:
        device_ok = False
    assert host_ok == device_ok == (max(q_len, r_len) <= swc.MAX_LEN)


def test_matrix_uploaded_once_per_device_matrix_and_gaps(monkeypatch):
    """Two flushes with the same scores align with the same cached matrix
    tensor; other gaps or another matrix get their own."""
    calls = _stub_plain(monkeypatch)
    monkeypatch.setattr(swc, "_MATRICES", {})
    qs, rs = zip(*_pairs([(40, 50)] * 4))
    for scores in (SCORES, SCORES, sw.get_matrix_scores("blosum62", 10, 1),
                   sw.get_matrix_scores("pam30", 10, 1), SCORES):
        swc.sw_batch_dispatch(list(qs), list(rs), scores, "cpu")
    assert calls[0] is calls[1] is calls[4]
    assert len({id(m) for m in calls}) == 3 and len(swc._MATRICES) == 3
    np.testing.assert_array_equal(calls[3].numpy(),
                                  sw.get_matrix_scores("pam30", 10, 1)
                                  .sub_matrix)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    rng = np.random.default_rng(12)
    tmp = tmp_path_factory.mktemp("torch_sync")
    seqs = ["".join(rng.choice(list(AA), size=int(rng.integers(40, 120))))
            for _ in range(80)]
    with open(tmp / "db.fasta", "w") as f:
        f.writelines(f">P{i} p\n{s}\n" for i, s in enumerate(seqs))
    build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")
    return SearchEngine(load_db(str(tmp / "db")), "cpu"), seqs


@pytest.mark.parametrize("positions", [False, True])
def test_engine_dispatch_reads_nothing_schedule_reads_totals(engine,
                                                             positions):
    """dispatch_batch only enqueues; schedule_batch reads the three totals
    vectors in one transfer and enqueues every chunk; the results are
    those of count_batch."""
    eng, seqs = engine
    queries = [s[5:100] for s in seqs[:40]]
    sizes = [len(q) - 6 for q in queries]
    with count_reads() as n:
        handle = eng.dispatch_batch(queries, sizes, k=10,
                                    positions=positions)
    assert n["reads"] == 0
    before = dict(eng.stats)
    with count_reads() as n:
        sched = eng.schedule_batch(handle)
    assert n["reads"] == 1
    assert sum(eng.stats.values()) > sum(before.values())
    got = eng.collect_batch(sched)
    want = eng.count_batch(queries, sizes, k=10, positions=positions)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.hit_rows, b.hit_rows)
        assert (a._bitmaps is not None) == positions


@pytest.mark.parametrize("shapes", [[(7,), (3, 5)], [(1,)], [(4, 383), (4, 128), (4,), (4,)]])
def test_staged_uploads_keep_every_array(shapes):
    """upload_all's staging: every array (any dtype, shape, 8-byte-aligned
    start in one buffer) comes back from its slice unchanged."""
    rng = np.random.default_rng(len(shapes))
    dtypes = [np.uint8, np.int32, np.int64, np.bool_, np.float32]
    arrays = [(rng.random(shape) * 100).astype(dtypes[i % len(dtypes)])
              for i, shape in enumerate(shapes)]
    staged, starts = _stage(arrays, pin=False)
    assert all(s % 8 == 0 for s in starts)
    for a, t in zip(arrays, _views(staged, arrays, starts)):
        assert t.shape == a.shape and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)
