"""End to end: the torch port's run_search and server vs the JAX package,
byte for byte, on one small domain-skewed database (CPU tensors)."""

import functools
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

import kaamer_tpu.ops.swalign_pallas as swalign_pallas
from kaamer_tpu.index.artifact import load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.search.options import NUCLEOTIDE, PROTEIN
from kaamer_tpu.search.pipeline import run_search as jax_run_search
from kaamer_tpu.server.app import _default_options
from kaamer_tpu_torch.ops import swalign as torch_swalign
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.search.pipeline import run_search
from kaamer_tpu_torch.server.app import make_server

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
    return art, tmp, SearchEngine(art, "cpu"), JaxEngine(art)


def _opts(path, out_format="tsv", positions=False, align=False, max_res=10):
    o = _default_options(PROTEIN)
    o.File, o.OutFormat = str(path), out_format
    o.ExtractPositions, o.Align, o.MaxResults = positions, align, max_res
    return o


@pytest.mark.parametrize("out_format,positions", [
    ("tsv", False), ("json", False), ("tsv", True), ("json", True)])
def test_run_search_bytes_equal_jax(db, out_format, positions):
    art, tmp, engine, jax_engine = db
    want = b"".join(jax_run_search(
        jax_engine, _opts(tmp / "q.fasta", out_format, positions)))
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
        jax_engine, _opts(tmp / "q_aln.fasta", align=True, max_res=3)))
    got = b"".join(run_search(engine, _opts(tmp / "q_aln.fasta", align=True,
                                            max_res=3)))
    assert got == want
    assert got.count(b"\n") > 5
    assert torch_swalign.HOST_DP_PAIRS == host_before  # went to the wavefront


def test_nucleotide_not_ported(db):
    art, tmp, engine, _ = db
    o = _opts(tmp / "q.fasta")
    o.SequenceType = NUCLEOTIDE
    with pytest.raises(NotImplementedError):
        b"".join(run_search(engine, o))


def test_hot_engine_not_ported(db):
    with pytest.raises(NotImplementedError, match="item 4"):
        SearchEngine(db[0], "cpu", hot=True)


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
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                url + "/api/search/nucleotide", data=data))
        assert err.value.code == 501
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_port_search_never_imports_jax(db):
    """Run in a fresh interpreter: the test process itself imports jax."""
    art, tmp, _, _ = db
    code = (
        "import sys\n"
        "from kaamer_tpu.index.artifact import load_db\n"
        "from kaamer_tpu.search.options import PROTEIN\n"
        "from kaamer_tpu.server.app import _default_options\n"
        "from kaamer_tpu_torch.search.engine import SearchEngine\n"
        "from kaamer_tpu_torch.search.pipeline import run_search\n"
        "import kaamer_tpu_torch.cli, kaamer_tpu_torch.server.app\n"
        "o = _default_options(PROTEIN)\n"
        f"o.File = {str(tmp / 'q_aln.fasta')!r}\n"
        "o.Align = True\n"
        f"e = SearchEngine(load_db({str(tmp / 'db')!r}), 'cpu')\n"
        "out = b''.join(run_search(e, o))\n"
        "assert out.count(b'\\n') > 2, out\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
