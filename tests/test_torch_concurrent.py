"""Concurrent requests on one engine: the port's server is a
ThreadingHTTPServer over a single SearchEngine (server/app.py:make_server),
so requests run at once in threads that share the engine.  Four client
threads POST four different requests at the same moment -- protein TSV,
JSON with positions, align=true and FASTQ reads -- for three rounds, to
one hot CPU engine on a small seed-77 skewed database; every body must
equal the same request's body served alone, byte for byte."""

import threading

import numpy as np
import pytest

from kaamer_tpu_torch.bench import data
from kaamer_tpu_torch.bench.serving import Served, post, requests
from kaamer_tpu_torch.search.engine import SearchEngine

ROUNDS = 3


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A hot CPU engine on a 1,500-protein skewed DB, and the four
    requests: R1 (protein TSV), R3 (JSON + positions), R2 (align=true)
    and R4 (FASTQ reads) of bench/serving.py, cut to 24 queries and 96
    reads."""
    art = data.ensure_db(str(tmp_path_factory.mktemp("conc") / "skew"),
                         data.build_skewed_db, 1500)
    engine = SearchEngine(art, "cpu")
    assert engine.hot_starts is not None
    rng = np.random.default_rng(2026)
    queries = data.make_queries(art, rng, 24)
    reqs = requests(queries, data.make_reads_fastq(art, rng, 96),
                    data.make_contigs_fasta(art, rng, 1))
    return engine, [r for r in reqs if r[0] in ("R1", "R2", "R3", "R4")]


@pytest.fixture(scope="module")
def serial(served):
    """The server's URL and each request's body served alone."""
    engine, reqs = served
    with Served(engine) as url:
        bodies = {}
        for name, route, fields, _ in reqs:
            status, body, _ = post(url + route, {"type": "string", **fields})
            assert status == 200, name
            bodies[name] = body
        assert bodies["R1"].count(b"\n") > 24
        assert b'"PositionHits"' in bodies["R3"]
        assert bodies["R4"].count(b"\n") > 48
        yield url, bodies


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_concurrent_bodies_equal_serial(served, serial, rnd):
    """Round rnd: the four requests from four threads released at once
    by a barrier; each body equals its serial body."""
    _, reqs = served
    url, bodies = serial
    start = threading.Barrier(len(reqs))
    got, errors = {}, []

    def client(name, route, fields):
        try:
            start.wait()
            got[name] = post(url + route, {"type": "string", **fields})[:2]
        except Exception as e:  # reported below
            errors.append((name, repr(e)))

    threads = [threading.Thread(target=client, args=(n, r, f))
               for n, r, f, _ in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for name, want in bodies.items():
        status, body = got[name]
        assert status == 200, name
        assert body == want, name
