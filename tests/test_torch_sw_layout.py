"""The SW kernel's on-chip direction layout, on the CPU.

csrc/swalign.cu keeps each pair's direction nibbles step-major,
[step][word][lane] with R query rows a lane, and picks its start cell by a
per-lane best and a warp reduction.  pack_dirs_nibbles rebuilds that
layout from the plain wavefront's direction bytes and
sw_walk_nibbles_plain repeats the kernel's start choice and walk over it,
with the kernel's index arithmetic; both must give sw_traceback_plain's
paths exactly, on random, tied and zero-score pairs."""

import numpy as np
import pytest
import torch

from kaamer_tpu_torch.ops import swalign_cuda as swc
from kaamer_tpu_torch.ops.matrices import LETTER_INDEX, get_matrix_scores

AA = "ACDEFGHIKLMNPQRSTVWY"
SCORES = get_matrix_scores("blosum62", 11, 1)


def _seq(rng, n):
    return "".join(rng.choice(list(AA), size=n))


def _pairs(rng, max_q):
    """Random related and unrelated pairs, ties and zero scores, with
    queries of at most max_q residues."""
    pairs = [("WWWW", "PPPP"), ("PPPPPPPP", "WWWWWWWWWWWW")]  # no positive cell
    for _ in range(6):
        q = _seq(rng, int(rng.integers(20, max_q + 1)))
        r = list(q)
        for _ in range(len(r) // 10):
            r[int(rng.integers(0, len(r)))] = AA[int(rng.integers(0, 20))]
        del r[5:9]
        pairs.append((q, "".join(r)))
        pairs.append((q, _seq(rng, int(rng.integers(20, 150)))))
    # ties: one motif twice in the query (two rows, far apart, reach the
    # maximum), twice in the reference (one row, two columns), and a
    # repeat of one residue (a plateau of equal cells)
    a = _seq(rng, 15)
    gap = max_q - 2 * len(a) - 1
    pairs += [(a + _seq(rng, gap) + a, a), (a, a + _seq(rng, 40) + a),
              ("W" * min(40, max_q), "W" * 37)]
    return pairs


def _tensors(pairs):
    codes = lambda s: LETTER_INDEX[np.frombuffer(s.encode(), np.uint8)]
    arrays = swc.pad_pairs([codes(q) for q, _ in pairs],
                           [codes(r) for _, r in pairs])
    mat = torch.from_numpy(SCORES.sub_matrix.astype(np.int32))
    return [torch.from_numpy(a) for a in arrays] + [mat]


@pytest.mark.parametrize("R,max_q", [(4, 127), (8, 255), (64, 300)])
def test_nibble_layout_walk_equals_traceback_plain(R, max_q):
    rng = np.random.default_rng(R)
    qc, rc, ql, rl, mat = _tensors(_pairs(rng, max_q))
    assert int(ql.max()) <= 32 * R
    dirs, best = swc.sw_wavefront_plain(qc, rc, ql, rl, mat, 11, 1)
    want = swc.sw_traceback_plain(dirs, best, ql)
    words = swc.pack_dirs_nibbles(dirs, ql, rl, R)
    assert words.shape[1:] == (int(rl.max()) + 31, (R + 7) // 8, 32)
    assert int(words.max()) < 2**32
    got = swc.sw_walk_nibbles_plain(words, best, ql, R, dirs.shape[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scores = want[0].tolist()
    assert scores[0] == scores[1] == 0 and min(scores[2:]) > 0
    assert int(want[3][-3]) > 0 and int(want[3][-1]) > 0


def test_nibble_of_one_cell():
    """Cell (i, j) of a lane other than 0, in a word other than 0: the
    kernel's address and shift, spelled out."""
    R, B, d_pad, W = 16, 1, 64, 40
    dirs = torch.zeros((B, d_pad, W), dtype=torch.uint8)
    i, j = 27, 5          # lane 1 (rows 17..32), t = 10: word 1, nibble 2
    dirs[0, i + j, i] = 13
    words = swc.pack_dirs_nibbles(dirs, torch.tensor([30], dtype=torch.int32),
                                  torch.tensor([9], dtype=torch.int32), R)
    s = j - 1 + 1
    assert int(words[0, s, 1, 1]) == 13 << 8
    assert int(words.sum()) == 13 << 8


def test_rows_per_lane_follows_the_buckets():
    assert [swc.rows_per_lane(128 * k - 1) for k in (1, 2, 3, 16)] == [
        4, 8, 12, 64]
    assert swc.rows_per_lane(2175) == 64  # a 2048-residue query: 32 x 64
