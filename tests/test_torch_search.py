"""End to end: the torch port's run_search and server vs the JAX package,
byte for byte, on one small domain-skewed database (CPU tensors).  Each
package loads the artifact with its own load_db and takes its options
from its own _default_options."""

import functools
import json
import os
import subprocess
import sys
import threading
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import kaamer_tpu.ops.swalign_pallas as swalign_pallas
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.search.options import NUCLEOTIDE, PROTEIN, READS
from kaamer_tpu.search.pipeline import run_search as jax_run_search
from kaamer_tpu.server.app import _default_options as jax_default_options
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.ops import swalign as torch_swalign
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.search.pipeline import run_search
from kaamer_tpu_torch.server.app import _default_options, make_server

from tests_codon_helper import encode_protein

AA = "ACDEFGHIKLMNPQRSTVWY"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_queries(path, rng, seqs, n, max_len):
    with open(path, "w") as f:
        for i in range(n):
            s = list(seqs[int(rng.integers(0, len(seqs)))][:max_len])
            for _ in range(int(rng.integers(0, 4))):
                s[int(rng.integers(0, len(s)))] = AA[int(rng.integers(0, 20))]
            f.write(f">q{i} query {i}\n{''.join(s)}\n")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Proteins of 1-3 power-law-popular domains with random linkers, and
    query files sampled from them with point mutations."""
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("torch_search")
    doms = ["".join(rng.choice(list(AA), size=int(rng.integers(20, 45))))
            for _ in range(12)]
    pop = 1.0 / (np.arange(12) + 2.0)
    pop /= pop.sum()
    seqs = []
    with open(tmp / "db.fasta", "w") as f:
        for i in range(250):
            parts = []
            for _ in range(int(rng.integers(1, 4))):
                parts.append("".join(rng.choice(list(AA),
                                                size=int(rng.integers(5, 15)))))
                parts.append(doms[int(rng.choice(12, p=pop))])
            seqs.append("".join(parts))
            f.write(f">SP{i:04d} skewed protein {i}\n{seqs[-1]}\n")
    build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")
    _write_queries(tmp / "q.fasta", rng, seqs, 40, 10**6)
    _write_queries(tmp / "q_aln.fasta", rng, seqs, 4, 120)
    art = load_db(str(tmp / "db"))
    return (art, tmp, SearchEngine(art, "cpu"),
            JaxEngine(jax_load_db(str(tmp / "db"))))


def _opts(path, out_format="tsv", positions=False, align=False, max_res=10,
          defaults=_default_options):
    o = defaults(PROTEIN)
    o.File, o.OutFormat = str(path), out_format
    o.ExtractPositions, o.Align, o.MaxResults = positions, align, max_res
    return o


@pytest.mark.parametrize("out_format,positions", [
    ("tsv", False), ("json", False), ("tsv", True), ("json", True)])
def test_run_search_bytes_equal_jax(db, out_format, positions):
    art, tmp, engine, jax_engine = db
    want = b"".join(jax_run_search(
        jax_engine, _opts(tmp / "q.fasta", out_format, positions,
                          defaults=jax_default_options)))
    got = b"".join(run_search(engine, _opts(tmp / "q.fasta", out_format,
                                            positions)))
    assert got == want
    assert len(got) > 2000


def test_aln_bytes_equal_jax(db, monkeypatch):
    """-aln through the plain SW versions vs the JAX package's Pallas
    kernel in interpret mode (its CPU path would otherwise be the host DP,
    whose tie endpoint may differ)."""
    art, tmp, engine, jax_engine = db
    monkeypatch.setattr(swalign_pallas, "sw_batch_dispatch", functools.partial(
        swalign_pallas.sw_batch_dispatch, interpret=True))
    host_before = torch_swalign.HOST_DP_PAIRS
    want = b"".join(jax_run_search(
        jax_engine, _opts(tmp / "q_aln.fasta", align=True, max_res=3,
                          defaults=jax_default_options)))
    got = b"".join(run_search(engine, _opts(tmp / "q_aln.fasta", align=True,
                                            max_res=3)))
    assert got == want
    assert got.count(b"\n") > 5
    assert torch_swalign.HOST_DP_PAIRS == host_before  # went to the wavefront


def test_engine_serves_hot_sets(db):
    """The default engine is hot, like the JAX engine, on the same sets."""
    art, _, engine, jax_engine = db
    assert engine.hot_starts is not None and engine.M is not None
    np.testing.assert_array_equal(engine.hot_starts.numpy(),
                                  np.asarray(jax_engine.hot_starts))
    assert engine.hot_thresh == jax_engine.hot_thresh
    np.testing.assert_array_equal(engine.M.float().numpy(),
                                  np.asarray(jax_engine.M).astype(np.float32))


@pytest.mark.parametrize("out_format,positions", [("tsv", False),
                                                  ("json", True)])
def test_hot_bytes_equal_cold(db, out_format, positions):
    art, tmp, engine, _ = db
    cold = SearchEngine(art, "cpu", hot=False)
    assert cold.hot_starts is None
    opts = _opts(tmp / "q.fasta", out_format, positions)
    before = dict(engine.stats)
    got = b"".join(run_search(engine, opts))
    assert got == b"".join(run_search(cold, opts))
    assert engine.stats["hot"] > before["hot"] and cold.stats["hot"] == 0


def _rerun_queries(art, n=48):
    """Proteins of the database repeated to 120 residues: wide plateaus of
    hot and cold totals, which a starved cold candidate list cannot
    certify."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        seq = art.sequence(int(rng.integers(0, art.num_proteins)))
        out.append((seq * 4)[:120])
    return out


def test_forced_reruns_agree_with_jax(db, tmp_path, monkeypatch):
    """_k_cold = 1 on both engines starves TAM's cold list: some rows fail
    the certificate, both engines flag the same rows and re-run them, and
    the results and run_search bytes stay equal."""
    art = db[0]
    engine = SearchEngine(art, "cpu")
    jax_engine = JaxEngine(jax_load_db(art.path))
    flagged = {"port": [], "jax": []}
    for name, eng in (("port", engine), ("jax", jax_engine)):
        eng._k_cold = 1
        orig = eng._dispatch_legacy
        monkeypatch.setattr(eng, "_dispatch_legacy",
                            lambda ctx, fl, o=orig, n=name: (
                                flagged[n].append(sorted(fl)) or o(ctx, fl)))
    queries = _rerun_queries(art)
    sizes = [len(q) - 6 for q in queries]
    got = engine.count_batch(queries, sizes, k=10)
    want = jax_engine.count_batch(queries, sizes, k=10)
    assert flagged["port"] == flagged["jax"] and flagged["port"]
    assert engine.stats["rerun_rows"] == sum(map(len, flagged["port"]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.hit_rows, b.hit_rows)
        np.testing.assert_array_equal(a.counts, b.counts)
    path = tmp_path / "rerun.fasta"
    path.write_text("".join(f">r{i} rerun\n{q}\n"
                            for i, q in enumerate(queries)))
    assert (b"".join(run_search(engine, _opts(path)))
            == b"".join(jax_run_search(
                jax_engine, _opts(path, defaults=jax_default_options))))


def test_min_top_gates_with_exact_counts(db):
    """min_top gating after re-runs uses the exact counts (the JAX test's
    precedence slip at tests/test_hotset.py:418, written out here: the
    top count first, then the comparison)."""
    art = db[0]
    engine = SearchEngine(art, "cpu")
    engine._k_cold = 1
    ref = SearchEngine(art, "cpu", hot=False)
    queries = _rerun_queries(art)
    sizes = [len(q) - 6 for q in queries]
    want = ref.count_batch(queries, sizes, k=10)
    tops = [int(b.counts[0]) if len(b.counts) else 0 for b in want]
    min_top = sorted(tops)[len(tops) // 2]
    gated = engine.resolve_batch(engine.dispatch_batch(queries, sizes, k=10),
                                 min_top=min_top)
    assert engine.stats["rerun_rows"] > 0
    n_kept = 0
    for g, b, top in zip(gated, want, tops):
        if top >= min_top:
            n_kept += 1
            np.testing.assert_array_equal(g.hit_rows, b.hit_rows)
            np.testing.assert_array_equal(g.counts, b.counts)
        else:
            assert g is None
    assert 0 < n_kept < len(queries)


def test_collect_rejects_another_min_top(db):
    """prefetch_batch gates with its min_top; a collect_batch with another
    would return rows gated by the stale value, so it raises."""
    art = db[0]
    engine = SearchEngine(art, "cpu")
    queries = _rerun_queries(art, 8)
    sizes = [len(q) - 6 for q in queries]
    sched = engine.prefetch_batch(engine.schedule_batch(
        engine.dispatch_batch(queries, sizes, k=10)), min_top=5)
    with pytest.raises(ValueError, match="min_top"):
        engine.collect_batch(sched, min_top=0)
    assert len(engine.collect_batch(sched, min_top=5)) == len(queries)


def test_host_fetch_keeps_bool_certificates():
    """A bool certificate comes back as numpy bool: as int32, ~exact is -1
    or -2, both truthy, and every hot row would read as uncertified."""
    from kaamer_tpu_torch.search.engine import _HostFetch

    ex = torch.tensor([True, False, True])
    counts = torch.tensor([[3, 1]], dtype=torch.int32)
    rows = torch.tensor([[7, 0xFFFFFFFF]], dtype=torch.int64)
    (c, r, e), = _HostFetch.device_get([[counts, rows, ex]])
    assert e.dtype == np.bool_ and (~e).tolist() == [False, True, False]
    assert c.dtype == np.int32 and r.dtype == np.uint32
    assert r.tolist() == [[7, 0xFFFFFFFF]]


def test_server_answers_over_http(db):
    art, tmp, engine, _ = db
    httpd = make_server(engine, 0, str(tmp), host="127.0.0.1")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/api/dbinfo") as resp:
            assert json.loads(resp.read())["NumberOfProteins"] == 250
        seq = open(tmp / "q.fasta").read()
        form = {"type": "string", "sequence": seq, "output-format": "json"}
        data = urllib.parse.urlencode(form).encode()
        with urllib.request.urlopen(urllib.request.Request(
                url + "/api/search/protein", data=data)) as resp:
            body = resp.read()
        want = b"".join(run_search(engine, _opts(tmp / "q.fasta", "json")))
        assert body == want
        # translated routes: reverse-translated database proteins as one
        # contig and as reads
        dna = ["taa" + encode_protein(art.sequence(i)) + "taa"
               for i in range(0, 40, 4)]
        nt_path, fq_path = tmp / "nt.fasta", tmp / "nt.fq"
        nt_path.write_text(">c1 contig\n" + "ccc".join(dna) + "\n")
        fq_path.write_text("".join(f"@r{i}\n{d}\n+\n{'I' * len(d)}\n"
                                   for i, d in enumerate(dna)))
        for route, path, seq_type in (("nucleotide", nt_path, NUCLEOTIDE),
                                      ("fastq", fq_path, READS)):
            form = {"type": "string", "sequence": path.read_text()}
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/api/search/" + route,
                    data=urllib.parse.urlencode(form).encode())) as resp:
                body = resp.read()
            o = _default_options(seq_type)
            o.File = str(path)
            assert body == b"".join(run_search(engine, o))
            assert body.count(b"\n") > 5
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_port_search_never_imports_jax(db):
    """Run in a fresh interpreter: the test process itself imports jax.
    The port serves -aln search on its own load_db and options, and neither
    jax nor the JAX package is imported."""
    art, tmp, _, _ = db
    code = (
        "import sys\n"
        "from kaamer_tpu_torch.index.artifact import load_db\n"
        "from kaamer_tpu_torch.search.options import PROTEIN\n"
        "from kaamer_tpu_torch.server.app import _default_options\n"
        "from kaamer_tpu_torch.search.engine import SearchEngine\n"
        "from kaamer_tpu_torch.search.pipeline import run_search\n"
        "import kaamer_tpu_torch.cli\n"
        "o = _default_options(PROTEIN)\n"
        f"o.File = {str(tmp / 'q_aln.fasta')!r}\n"
        "o.Align = True\n"
        f"e = SearchEngine(load_db({str(tmp / 'db')!r}), 'cpu')\n"
        "out = b''.join(run_search(e, o))\n"
        "assert out.count(b'\\n') > 2, out\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'kaamer_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
