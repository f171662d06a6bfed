"""The plain reference against the program on a tiny seed-77 database
served on the CPU: every record of a request, both routes, and the
reference's parts against a naive dictionary count and the program's own
Python ORF scan."""

import threading

import numpy as np
import pytest

from benchmark import registry
from benchmark.client import multipart, post, sampled_rows
from benchmark.generate import make_request
from benchmark.judges import tsv
from benchmark.reference import kmers, orf

from .conftest import BENCH, TRAFFIC


@pytest.fixture(scope="module")
def served(tiny_db):
    from kaamer_tpu_torch.server import app

    engine = app.load_engine(tiny_db.artifact, "cpu")
    httpd = app.make_server(engine, port=0, host="127.0.0.1")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    t.join()


@pytest.mark.parametrize("workload", ["tiny-proteome", "tiny-reads"])
def test_every_record_equals_the_reference(served, tiny_db, workload):
    mix = registry.cell(workload, BENCH, TRAFFIC).mix
    opts = tsv.options(mix["fields"])
    with_rows = 0
    for index in range(2):
        req = make_request(mix, tiny_db, 2**32 + 17, 0, index)
        status, body = post(served, mix["route"],
                            *multipart(mix["fields"], req.text), 120)
        assert status == 200
        got = sampled_rows(body.decode(), req.names, range(len(req.names)))
        for i, (name, seq) in enumerate(zip(req.names, req.seqs)):
            exp = tsv.expected(tiny_db, mix["route"], opts, name, seq)
            assert tsv.grouped(got[i]) == tsv.grouped(exp), name
            with_rows += bool(exp)
    assert with_rows > len(req.names) // 3


def test_counts_equal_a_dictionary_count(tiny_db):
    rng = np.random.default_rng(3)
    index = {}
    for r in range(tiny_db.n_proteins):
        s = tiny_db.protein(r).tobytes().decode()
        for i in range(len(s) - 6):
            index.setdefault(s[i:i + 7], set()).add(r)
    for _ in range(20):
        r = int(rng.integers(0, tiny_db.n_proteins))
        q = tiny_db.protein(r).tobytes().decode()[5:120]
        counts = {}
        for i in range(len(q) - 6):
            for p in index.get(q[i:i + 7], ()):
                counts[p] = counts.get(p, 0) + 1
        want = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        rows, c, _ = tiny_db.postings.ranked_hits(
            kmers.seq_codes(q, len(q) - 6))
        assert list(zip(rows.tolist(), c.tolist())) == want


def test_orf_scan_equals_the_programs_python_scan():
    from kaamer_tpu_torch.search.orf import _get_orfs_py

    rng = np.random.default_rng(4)
    for n in (156, 157, 158, 400, 1000):
        for _ in range(10):
            dna = "".join(rng.choice(list("acgt"), size=n))
            mine = [(o.seq, o.start, o.end, o.plus, o.alts)
                    for o in orf.orfs(dna)]
            theirs = [(o.Sequence, o.Location.StartPosition,
                       o.Location.EndPosition, o.Location.PlusStrand,
                       o.Location.StartsAlternative)
                      for o in _get_orfs_py(dna, 11)]
            assert mine == theirs


def test_bf16_rounding():
    from benchmark.reference.rows import bf16, pct

    assert bf16([257.0, 258.0, 259.0, 256.0]).tolist() == [
        256.0, 258.0, 260.0, 256.0]
    assert pct(44, 46, "float32") == "95.65"
    assert pct(44, 46, "bfloat16") != pct(44, 46, "float32")


def test_an_answer_that_never_came_is_wrong(tiny_db):
    mix = registry.cell("tiny-proteome", BENCH, TRAFFIC).mix
    req = make_request(mix, tiny_db, 3, 0, 0)
    i = req.sample[0]
    exp = tsv.expected(tiny_db, mix["route"], tsv.options({}), req.names[i],
                       req.seqs[i])
    recs = [{"ok": True, "sample": [{"name": req.names[i],
                                     "seq": req.seqs[i], "rows": exp}]},
            {"ok": False, "sample": [{"name": req.names[i],
                                      "seq": req.seqs[i], "rows": None}]}]
    got = tsv.judge(tiny_db, mix["route"], tsv.options({}), recs)
    assert got == {"queries_wrong": {"value": 1, "limit": 0}}
