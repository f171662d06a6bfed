"""The -aln cell on the CPU: the plain alignment reference on pairs that
hit each tie rule, a served -aln run of the tiny seed-77 database judged
record by record against it, planted faults and the bfloat16 control
coming out not correct, and the readers of the alignment metrics on a
hand-made trace."""

import json

import numpy as np
import pytest

from benchmark import control, registry
from benchmark.reference import align as aln
from benchmark.run import Context
from benchmark.tracefile import WINDOW, Trace

from .conftest import DATA, TRAFFIC, last_json, run_cell

BENCH = f"{DATA}/bench_aln.json"
CELL = "tiny-proteome-aln"
MAT = aln.MATRIX

# (query, subject, score, query columns, subject columns): BLOSUM62, gaps
# 11/1, each pair meeting one tie rule on its path
TIES = {
    # C-C (9) at (1, 4) and (1, 5): the first j
    "first j": ("CGGWWWA", "LKECCEKK", 9, [0], [3]),
    # W-W (11) at (2, 9) and (3, 9): the lowest i
    "lowest i": ("CWW", "PLPLGALEW", 11, [1], [8]),
    # LPW against LPW (4 + 7 + 11); on the way H equals both its diagonal
    # and E: the diagonal
    "diagonal before E": ("GACLPWG", "PACLLPLPWAL", 22, [3, 4, 5],
                          [6, 7, 8]),
    # H equals both its diagonal and F: the diagonal
    "diagonal before F": ("ACKLKWA", "AGCKAWAG", 17, [1, 2, 3, 4, 5, 6],
                          [2, 3, -1, 4, 5, 6]),
    # H equals E and F, not its diagonal: E, a gap in the query
    "E before F": ("CCCGWEAE", "ACGCWE", 20, [2, 3, -1, 4, 5],
                   [1, 2, 3, 4, 5]),
    # in E, E equals both H - open and E - extend: back to H
    "E back to H": ("GCLLCWL", "LCCEWLEEWL", 16, [2, 3, 4, -1, 5, 6],
                    [0, 1, 2, 3, 4, 5]),
}


@pytest.mark.parametrize("rule", sorted(TIES))
def test_reference_paths_on_each_tie_rule(rule):
    q, r, score, q_ops, r_ops = TIES[rule]
    assert aln.paths([(q, r)], MAT, 11, 1) == [(score, q_ops, r_ops)]


def test_reference_fields_of_one_pair():
    """LPW against LPW: 3 columns, all identical; raw 22, bit score
    (0.267 * 22 + 3.194) / 0.693, E-value m n / 2^S'."""
    a = aln.align_pairs([("GACLPWG", "PACLLPLPWAL")], 1000)[0]
    assert (a.length, a.mismatches, a.gap_openings, a.raw) == (3, 0, 0, 22)
    assert (a.qstart, a.qend, a.sstart, a.send) == (4, 6, 7, 9)
    assert a.identity == 100.0
    bits = (0.267 * 22 - np.log(0.041)) / np.log(2)
    assert a.bitscore == pytest.approx(bits, rel=1e-15)
    assert a.evalue == pytest.approx(7 * 1000 / 2 ** bits, rel=1e-15)
    gapped = aln.align_pairs([("CCCGWEAE", "ACGCWE")], 1000)[0]
    assert (gapped.length, gapped.gap_openings, gapped.raw) == (
        5, 1, 9 + 6 + 11 + 5 - 11)
    long = "".join(np.random.default_rng(1).choice(
        list("ACDEFGHIKLMNPQRSTVWY"), size=700))
    self_hit = aln.align_pairs([(long, long)], 10 ** 8)[0]
    assert self_hit.bitscore >= 1024 and self_hit.evalue == 0.0


def test_reference_blocks_give_each_pair_its_own_path():
    """Pairs aligned in one block and alone give the same paths."""
    rng = np.random.default_rng(3)
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    pairs = []
    for _ in range(12):
        q = "".join(rng.choice(aa, size=int(rng.integers(20, 200))))
        r = q[5:] if rng.random() < 0.5 else "".join(
            rng.choice(aa, size=int(rng.integers(20, 200))))
        pairs.append((q, r))
    pairs += [(q, r) for q, r, *_ in TIES.values()]
    together = aln.paths(pairs, MAT, 11, 1)
    assert together == [aln.paths([p], MAT, 11, 1)[0] for p in pairs]


@pytest.fixture(scope="module")
def aln_db(cache_root):
    from benchmark import database

    cell = registry.cell(CELL, BENCH, TRAFFIC)
    return database.ensure(cell.config, cache_root, log=lambda *a: None)


def test_served_aln_run_is_correct(cache_root, aln_db):
    """Every record of every request judged against reference/align.py."""
    rc, out, err = run_cell(CELL, 2**31 + 77, cache_root, bench=BENCH)
    assert rc == 0, "\n".join(err[-30:])
    res = last_json(out)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["queries_wrong"] == {"value": 0, "limit": 0}
    judged = next(l for l in err if l.startswith("judge: compared"))
    assert int(judged.split(" alignments")[0].rsplit(" ", 1)[1]) > 0
    stats = next(l for l in err if l.startswith("window:"))
    assert "'aln_host_pairs': 0" in stats and "'aln_pairs': 0" not in stats


@pytest.mark.parametrize("fault", ["last_j", "e_before_diagonal",
                                   "gap_open_10", "qstart_off_by_one"])
def test_a_planted_aln_fault_is_not_correct(cache_root, aln_db, fault):
    rc, out, err = run_cell(CELL, 11, cache_root, bench=BENCH,
                            plant=f"benchmark.tests.faults_aln:{fault}")
    assert rc == 0, "\n".join(err[-30:])
    res = last_json(out)
    assert res["correct"] is False
    assert res["checks"]["queries_wrong"]["value"] > 0


def test_the_aln_control_is_not_correct(cache_root, aln_db, capsys):
    control.main(["--workload", CELL, "--seeds", "1,2,3", "--requests", "1"],
                 bench_path=BENCH, traffic_dir=TRAFFIC,
                 cache_root=cache_root)
    got = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l]
    assert len(got) == 3
    assert all(g["correct"] is False for g in got)
    assert min(g["checks"]["queries_wrong"]["value"] for g in got) > 0


def _ann(name, ts, dur, tid):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid, "args": {}}


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 20, "args": {}}


def test_alignment_readers_on_a_saved_trace(tmp_path):
    """Window 0-1000 us.  Two kaamer.align.kernel launches in it of 10^6
    and 3 x 10^6 real cells (17 operations a cell at 16.7e12 a second:
    4.0719 us in all), a third before the window; their kernels ran 20 +
    30 us, another kernel 100 us.  Requests 900 + 1000 us on two threads,
    the alignment step 200 + 100 + 150 us of them."""
    events = [
        _ann(WINDOW, 0, 1000, 1),
        _ann("kaamer.request", 0, 900, 7),
        _ann("kaamer.request", 0, 1000, 8),
        _ann("kaamer.align.dispatch", 100, 200, 7),
        _ann("kaamer.align.kernel:1000000:1500000:9000", 150, 5, 7),
        _ann("kaamer.align.resolve", 400, 100, 7),
        _ann("kaamer.align.dispatch", 500, 150, 8),
        _ann("kaamer.align.kernel:3000000:4000000:30000", 520, 5, 8),
        _ann("kaamer.align.kernel:5000000:5000000:30000", -50, 5, 8),
        _kernel("void sw_align_kernel<12, true>(...)", 160, 20),
        _kernel("void sw_align_kernel<16, false>(...)", 530, 30),
        _kernel("void sw_align_kernel<16, false>(...)", -40, 30),
        _kernel("other", 600, 100),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = Trace(str(path))
    ctx = Context(None, [], (0, 1), {}, trace.spans, trace)
    from benchmark.metrics._sw_peaks import sw_cost
    least = sw_cost(10 ** 6, 9000) + sw_cost(3 * 10 ** 6, 30000)
    assert least == pytest.approx(17 * 4e6 / 16.7e12)
    roof = registry.reader("kernel.sw_align_roofline")(ctx)
    assert roof == pytest.approx(100 * least / 50e-6)
    share = registry.reader("align.host_share")(ctx)
    assert share == pytest.approx(100 * 450 / 1900)
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"traceEvents": [
        e for e in events if "align" not in e["name"]]}))
    old = Trace(str(plain))
    ctx = Context(None, [], (0, 1), {}, old.spans, old)
    assert registry.reader("kernel.sw_align_roofline")(ctx) is None
    assert registry.reader("align.host_share")(ctx) is None
