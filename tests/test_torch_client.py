"""The port's search client, kaamer CLI and server routes against the JAX
package's, exactly: the port's client against the port's server gives
JAX's client's bytes against JAX's server (file and path mode; protein,
nucleotide and FASTQ; TSV and JSON; -aln and -pos), the static routes
answer alike, the kaamer and dispatcher CLIs print and return alike; and
the public align / align_batch / position_bitmaps give JAX's results."""

import dataclasses
import functools
import http.client
import io
import os
import re
import socket
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import kaamer_tpu.ops.swalign_pallas as swalign_pallas
from kaamer_tpu import cli as jax_cli
from kaamer_tpu.index.artifact import load_db as jax_load_db
from kaamer_tpu.index.build import build_db
from kaamer_tpu.ops import swalign as jax_swalign
from kaamer_tpu.parallel import dist as jax_dist
from kaamer_tpu.search.engine import SearchEngine as JaxEngine
from kaamer_tpu.server import app as jax_app
from kaamer_tpu.server import client as jax_client
from kaamer_tpu_torch import cli
from kaamer_tpu_torch.index.artifact import load_db
from kaamer_tpu_torch.ops import swalign
from kaamer_tpu_torch.parallel.dist import ShardedSearchEngine
from kaamer_tpu_torch.search.engine import SearchEngine
from kaamer_tpu_torch.server import app, client
from tests_codon_helper import encode_protein

AA = "ACDEFGHIKLMNPQRSTVWY"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """200 proteins of power-law-popular domains, and query files: 5
    proteins, 3 contigs of 2 reverse-translated genes, 8 reads."""
    rng = np.random.default_rng(41)
    tmp = tmp_path_factory.mktemp("torch_client")
    doms = ["".join(rng.choice(list(AA), size=int(rng.integers(20, 45))))
            for _ in range(10)]
    pop = 1.0 / (np.arange(10) + 2.0)
    pop /= pop.sum()
    seqs = []
    for _ in range(200):
        parts = []
        for _ in range(int(rng.integers(1, 4))):
            parts.append("".join(rng.choice(list(AA),
                                            size=int(rng.integers(5, 15)))))
            parts.append(doms[int(rng.choice(10, p=pop))])
        seqs.append("".join(parts))
    (tmp / "db.fasta").write_text("".join(
        f">SP{i:04d} client protein {i}\n{s}\n" for i, s in enumerate(seqs)))
    build_db(str(tmp / "db"), str(tmp / "db.fasta"), "fasta")
    files = {
        "prot": "".join(f">q{i}\n{seqs[j][:90]}\n"
                        for i, j in enumerate((2, 17, 40, 77, 150))),
        "nt": "".join(
            f">c{i} contig\n" + "ccgta".join(
                "atg" + encode_protein(seqs[j][:60]) + "taa"
                for j in (5 * i, 5 * i + 9)) + "\n" for i in range(3)),
        "fastq": "".join(
            f"@r{i}\n{d}\n+\n{'I' * len(d)}\n" for i, d in enumerate(
                "taa" + encode_protein(seqs[11 * i][:40]) + "taa"
                for i in range(8))),
    }
    for name, text in files.items():
        (tmp / f"q.{name}").write_text(text)
    return {"tmp": tmp, "seqs": seqs, "path": str(tmp / "db"),
            "files": {n: str(tmp / f"q.{n}") for n in files}}


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """The JAX package's -aln runs its Pallas kernel in interpret mode (its
    CPU path would otherwise be the host DP, whose tie endpoint may
    differ from the wavefront's)."""
    monkeypatch.setattr(swalign_pallas, "sw_batch_dispatch", functools.partial(
        swalign_pallas.sw_batch_dispatch, interpret=True))


def _jax_web_dirs():
    """The JAX server's static directories (kaamer_tpu/server/app.py:
    304-311)."""
    return {"/docs": os.path.join(REPO, "docs"),
            "/web": os.path.join(REPO, "web", "public")}


@pytest.fixture(scope="module")
def servers(db):
    """The JAX server (its handler on its engine) and the port's
    (make_server on SearchEngine(cpu)), both on free ports of every
    interface, as the CLI's servers listen (so that 127.0.0.2 reaches
    them too)."""
    tmp = str(db["tmp"])
    jax_httpd = ThreadingHTTPServer(("", 0), jax_app.make_handler(
        JaxEngine(jax_load_db(db["path"])), tmp, _jax_web_dirs()))
    port_httpd = app.make_server(SearchEngine(load_db(db["path"]), "cpu"), 0,
                                 tmp)
    urls = {}
    for name, httpd in (("jax", jax_httpd), ("torch", port_httpd)):
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        urls[name] = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield urls
    for httpd in (jax_httpd, port_httpd):
        httpd.shutdown()
        httpd.server_close()


# (query type, output format, positions, align)
CASES = [("prot", "tsv", False, False), ("prot", "json", True, False),
         ("prot", "tsv", False, True), ("nt", "tsv", False, False),
         ("nt", "json", True, True), ("fastq", "tsv", False, False),
         ("fastq", "json", True, False)]


@pytest.mark.parametrize("mode", ["path", "file"])
@pytest.mark.parametrize("qtype,fmt,pos,aln", CASES,
                         ids=lambda v: str(v))
def test_search_request_bytes_equal_jax(db, servers, mode, qtype, fmt, pos,
                                        aln):
    bodies = {}
    for name, mod in (("jax", jax_client), ("torch", client)):
        out = io.StringIO()
        mod.search_request(
            servers[name], db["files"][qtype], cli._VALID_QUERY_TYPE[qtype],
            input_type=mode, out_format=fmt, positions=pos, align=aln,
            max_results=3 if aln else 10, output=out)
        bodies[name] = out.getvalue()
    assert bodies["torch"] == bodies["jax"]
    assert bodies["torch"].count("\n") > 3 or fmt == "json"
    if aln and fmt == "json":  # a hit with a non-empty alignment
        assert re.search(r'"AlnString": *"[A-Z*]', bodies["torch"])


@pytest.mark.parametrize("host,mode", [("127.0.0.1", "path"),
                                       ("127.0.0.2", "file")])
def test_kaamer_cli_bytes_equal_jax(db, servers, tmp_path, host, mode):
    """`search` through each package's dispatcher against its server:
    a host naming this machine sends the query's path, any other host
    (127.0.0.2 here) uploads the file; both write JAX's bytes."""
    outs = {}
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        url = servers[name].replace("127.0.0.1", host)
        out = tmp_path / f"{name}.json"
        assert main(["search", "-i", db["files"]["prot"], "-t", "prot",
                     "-h", url, "-fmt", "json", "-pos", "-aln", "-m", "3",
                     "-o", str(out)]) == 0
        outs[name] = out.read_bytes()
    assert outs["torch"] == outs["jax"] and len(outs["torch"]) > 100


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_client_without_server_equals_jax(db, capsys):
    url = f"http://127.0.0.1:{_closed_port()}"
    got = {}
    for name, mod in (("jax", jax_client), ("torch", client)):
        with pytest.raises(SystemExit) as e:
            mod.search_request(url, db["files"]["prot"], 1)
        got[name] = (e.value.code, capsys.readouterr().out)
    assert got["torch"] == got["jax"] == (
        1, f"No kaamer-db server running at {url}\n")


def test_client_prints_the_servers_error(servers, capsys):
    """A 400 (a path the server cannot see) prints the server's message
    and exits 1.  The JAX client exits 1 too, but its URLError handler
    catches the HTTPError first and says no server is running."""
    missing = "/nonexistent/q.fasta"
    with pytest.raises(SystemExit) as e:
        client.search_request(servers["torch"], missing, 1)
    assert e.value.code == 1
    assert capsys.readouterr().out == "File does not exist!\n\n"
    with pytest.raises(SystemExit) as e:
        jax_client.search_request(servers["jax"], missing, 1)
    assert e.value.code == 1
    assert "No kaamer-db server running" in capsys.readouterr().out


STATIC = ["/", "/web/", "/web/index.html", "/docs/README.md",
          "/docs/missing.md", "/docs/../kaamer_tpu/cli.py", "/nothing"]


@pytest.mark.parametrize("path", STATIC)
def test_static_routes_equal_jax(servers, path):
    """Status, Location, Content-Type and body of GET path (sent as is,
    a ../ escape included) are JAX's."""
    got = {}
    for name, url in servers.items():
        conn = http.client.HTTPConnection(url.split("//")[1], timeout=30)
        conn.request("GET", path)
        resp = conn.getresponse()
        got[name] = (resp.status, resp.getheader("Location"),
                     resp.getheader("Content-Type"), resp.read())
        conn.close()
    assert got["torch"] == got["jax"]
    status = got["torch"][0]
    if path in ("/web/", "/web/index.html", "/docs/README.md"):
        rel = "web/public/index.html" if path.startswith("/web") else \
            "docs/README.md"
        assert status == 200
        assert got["torch"][3] == open(os.path.join(REPO, rel), "rb").read()
    else:
        assert status == (302 if path == "/" else 404)


def test_web_dirs_equal_jax():
    assert app.web_dirs() == _jax_web_dirs()


# kaamer (search client) branches that print and return
SEARCH_ERRORS = [
    [], ["-search"], ["-search", "-i", "q.fasta"],
    ["-search", "-i", "q.fasta", "-t", "dna"],
    ["-search", "-i", "q.fasta", "-t", "prot", "-g", "7"],
    ["-search", "-i", "q.fasta", "-t", "nt", "-fmt", "xml"],
    ["-search", "-i", "q.fasta", "-t", "fastq", "-h", "localhost:8321"],
    ["-search", "-i", "q.fasta", "-t", "prot", "-mat", "pam1"],
    ["-search", "-i", "q.fasta", "-t", "prot", "-gop", "99"],
]


@pytest.mark.parametrize("argv", SEARCH_ERRORS,
                         ids=lambda a: " ".join(a) or "none")
def test_kaamer_cli_messages_equal_jax(argv, capsys):
    got = {}
    for name, main in (("jax", jax_cli.kaamer_main), ("torch", cli.kaamer_main)):
        code = main(argv)
        got[name] = (code, capsys.readouterr().out)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (1 if argv else 0)


@pytest.mark.parametrize("argv", [[], ["x"], ["db"], ["db", "-index"],
                                  ["search"], ["search", "-t", "prot"],
                                  ["search", "-i", "q.fasta"]],
                         ids=lambda a: " ".join(a) or "none")
def test_main_dispatches_as_jax(argv, capsys):
    """db goes to kaamer-db, search to kaamer -search, anything else
    prints the usage line and returns 1 (the module name is each
    package's)."""
    got = {}
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        code = main(argv)
        got[name] = (code, capsys.readouterr().out.replace(
            "kaamer_tpu_torch.cli", "kaamer_tpu.cli"))
    if argv == ["db"]:  # the help texts differ by -device and downloads
        assert got["torch"][0] == got["jax"][0] == 0
        assert got["torch"][1].startswith("usage: kaamer-db")
    else:
        assert got["torch"] == got["jax"]


def test_search_parser_options_equal_jax():
    def options(parser):
        return {tuple(a.option_strings): (a.dest, a.default)
                for a in parser._actions}

    assert options(cli._search_parser()) == options(jax_cli._search_parser())


def _pairs(seqs, n, long=False):
    rng = np.random.default_rng(n)
    pairs = []
    for _ in range(n):
        q = seqs[int(rng.integers(0, len(seqs)))]
        s = list(q)
        for _ in range(int(rng.integers(0, 5))):
            s[int(rng.integers(0, len(s)))] = AA[int(rng.integers(0, 20))]
        pairs.append(("".join(s[3:]) + "U", q))
    if long:
        pairs.append(("".join(rng.choice(list(AA), size=2100)), seqs[0]))
    return pairs


@pytest.mark.parametrize("n,long", [(3, False), (12, False), (6, True)],
                         ids=["host-dp", "plain-sw", "too-long"])
def test_align_batch_equals_jax(db, n, long):
    """align_batch on the CPU: batches under 4 pairs or with a sequence
    past 2048 go to the host DP in both packages, the others to the
    plain sw_align here and to the Pallas kernel (interpret mode) there."""
    art = load_db(db["path"])
    pairs = _pairs(db["seqs"], n, long)
    got = swalign.align_batch(pairs, art.stats, device="cpu")
    want = jax_swalign.align_batch(pairs, jax_load_db(db["path"]).stats)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]
    assert all(r.AlnString for r in got)


def test_align_equals_jax(db):
    art = load_db(db["path"])
    for q, r in _pairs(db["seqs"], 4):
        got = swalign.align(q, r, art.stats, "blosum62", 11, 1, device="cpu")
        want = jax_swalign.align(q, r, art.stats, "blosum62", 11, 1)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("positions", [True, False],
                         ids=["device-bitmaps", "host-bitmaps"])
@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_position_bitmaps_equal_jax(db, kind, positions):
    """position_bitmaps (lists of bools) of every hit of every query, from
    the bitmaps the batch computed or from the host binary search."""
    art, jax_art = load_db(db["path"]), jax_load_db(db["path"])
    if kind == "single":
        eng, jax_eng = SearchEngine(art, "cpu"), JaxEngine(jax_art)
    else:
        eng = ShardedSearchEngine(art, [["cpu"] * 2])
        jax_eng = jax_dist.ShardedSearchEngine(
            jax_art, mesh=jax_dist.global_mesh(2))
    seqs = [s[:80] for s in db["seqs"][:24:3]]
    sizes = [len(s) - 6 for s in seqs]
    got = eng.count_batch(seqs, sizes, k=10, positions=positions)
    want = jax_eng.count_batch(seqs, sizes, k=10, positions=positions)
    n = 0
    for qc, jqc in zip(got, want):
        rows = [int(r) for r in jqc.hit_rows]
        bm = eng.position_bitmaps(qc, rows)
        assert bm == jax_eng.position_bitmaps(jqc, rows)
        assert all(type(v) is list and type(v[0]) is bool
                   for v in bm.values())
        n += len(bm)
    assert n > 20
