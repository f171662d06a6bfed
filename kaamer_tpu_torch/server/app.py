"""HTTP API server on the torch engine (kaamer_tpu/server/app.py).

  GET  /api/dbinfo                        -> KStats JSON
  POST /api/search/{protein,nucleotide,fastq} -> streamed TSV/JSON, form
                                             fields as the JAX server's
                                             (parse_search_options)
  GET  /                                  -> 302 /web/
  GET  /docs/*, /web/*                    -> static, from the repo's docs/
                                             and web/public/ (when the
                                             directories exist)

Form parsing, option parsing, the default options, the disconnect poller
and the static file server are the JAX server's
(kaamer_tpu/server/app.py:42-164,197-215), copied unchanged; the rest of
the handler is this module's own.

A `kaamer.request` span (trace.span) holds a POST's whole handling, on
its handler thread.
"""

from __future__ import annotations

import email.parser
import email.policy
import json
import os
import select
import socket
import tempfile
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..index.artifact import load_db
from ..search.engine import SearchEngine
from ..search.options import NUCLEOTIDE, PROTEIN, READS, SearchOptions
from ..search.pipeline import run_search
from ..trace import span

# search route -> SequenceType (kaamer_tpu/server/app.py:219-223)
ROUTES = {
    "/api/search/protein": PROTEIN,
    "/api/search/nucleotide": NUCLEOTIDE,
    "/api/search/fastq": READS,
}


def _parse_form(handler: BaseHTTPRequestHandler):
    """Parse urlencoded or multipart form bodies into ({field: value},
    {field: bytes})."""
    length = int(handler.headers.get("Content-Length") or 0)
    body = handler.rfile.read(length) if length else b""
    ctype = handler.headers.get("Content-Type", "")

    fields = {}
    files = {}
    if ctype.startswith("multipart/form-data"):
        raw = (
            b"Content-Type: " + ctype.encode() + b"\r\nMIME-Version: 1.0\r\n\r\n" + body
        )
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(raw)
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name is None:
                continue
            payload = part.get_payload(decode=True) or b""
            filename = part.get_filename()
            if filename is not None:
                files[name] = payload
            else:
                fields[name] = payload.decode("utf-8", errors="replace")
    elif ctype.startswith("application/x-www-form-urlencoded"):
        for k, v in urllib.parse.parse_qsl(body.decode("utf-8", errors="replace")):
            fields[k] = v
    return fields, files


def parse_search_options(
    opts: SearchOptions, fields: dict, files: dict, tmp_folder: str
):
    """parseSearchOptions equivalent (api/server.go:220-315).  Returns an
    error string or None."""
    input_type = fields.get("type", "")
    opts.InputType = input_type
    if input_type == "string":
        path = os.path.join(tmp_folder, uuid.uuid4().hex + ".fasta")
        with open(path, "w") as f:
            f.write(fields.get("sequence", ""))
        opts.File = path
    elif input_type == "file":
        if "file" not in files:
            return "no file uploaded"
        path = os.path.join(tmp_folder, uuid.uuid4().hex + ".fasta")
        with open(path, "wb") as f:
            f.write(files["file"])
        opts.File = path
    elif input_type == "path":
        f = fields.get("file", "")
        if f:
            if not os.path.exists(f):
                return "File does not exist!"
            opts.File = f
    else:
        return "Need request type (string|file|path)"

    def _int(name, default):
        try:
            return int(fields.get(name, ""))
        except ValueError:
            return default

    def _float(name, default):
        try:
            return float(fields.get(name, ""))
        except ValueError:
            return default

    if fields.get("max-results", ""):
        opts.MaxResults = _int("max-results", opts.MaxResults)
    opts.GeneticCode = _int("gcode", opts.GeneticCode)
    if fields.get("output-format", "").lower() == "json":
        opts.OutFormat = "json"
    if fields.get("positions", "").lower() == "true":
        opts.ExtractPositions = True
    if fields.get("annotations", "").lower() == "true":
        opts.Annotations = True
    if fields.get("align", "").lower() == "true":
        opts.Align = True
    opts.MinKMatch = _int("minkmatch", opts.MinKMatch)
    opts.MinKRatio = _float("minkratio", opts.MinKRatio)
    if fields.get("sub-matrix", "").lower() not in ("", "blosum62"):
        opts.SubMatrix = fields["sub-matrix"].lower()
    opts.GapOpen = _int("gap-open", opts.GapOpen)
    opts.GapExtend = _int("gap-extend", opts.GapExtend)
    return None


def _disconnect_poller(conn: socket.socket):
    """Zero-timeout liveness check on the client socket: after the request
    body is consumed, the connection becoming readable with EOF (or an
    error) means the client went away.  The pipeline polls this between
    device batches -- the reference instead polls the request context every
    3 seconds during a search (search.go:157-166); per-batch polling reacts
    faster at negligible cost (one select syscall per batch)."""

    def cancelled() -> bool:
        try:
            r, _, _ = select.select([conn], [], [], 0)
            if r:
                return conn.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True
        return False

    return cancelled


def _default_options(seq_type: int) -> SearchOptions:
    return SearchOptions(
        GeneticCode=11,
        SequenceType=seq_type,
        OutFormat="tsv",
        MaxResults=10,
        ExtractPositions=False,
        MinKMatch=10,
        MinKRatio=0.05,
        SubMatrix="blosum62",
        GapOpen=11,
        GapExtend=1,
    )


# static file types (kaamer_tpu/server/app.py:208-212)
CONTENT_TYPES = {
    ".html": "text/html", ".js": "application/javascript",
    ".css": "text/css", ".json": "application/json",
    ".md": "text/markdown",
}


def web_dirs() -> dict:
    """URL prefix -> directory of the static routes: the repo's docs/ and
    web/public/, where they exist (kaamer_tpu/server/app.py:304-311)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dirs = {}
    docs = os.path.join(repo, "docs")
    if os.path.isdir(docs):
        dirs["/docs"] = docs
    web = os.path.join(repo, "web", "public")
    if os.path.isdir(web):
        dirs["/web"] = web
    return dirs


def make_handler(engine: SearchEngine, tmp_folder: str, web_dirs: dict):
    db_stats = engine.art.stats

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, data: bytes, ctype: str = "text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/":
                self.send_response(302)
                self.send_header("Location", "/web/")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            if path == "/api/dbinfo":
                self._reply(200, json.dumps(db_stats.to_json_obj()).encode(),
                            "application/json")
                return
            for prefix, root in web_dirs.items():
                if path.startswith(prefix):
                    return self._serve_static(root, path[len(prefix):])
            self.send_error(404)

        def _serve_static(self, root, rel):
            rel = rel.lstrip("/") or "index.html"
            full = os.path.realpath(os.path.join(root, rel))
            if not full.startswith(os.path.realpath(root)) or not os.path.isfile(full):
                self.send_error(404)
                return
            with open(full, "rb") as f:
                data = f.read()
            ext = os.path.splitext(full)[1]
            self._reply(200, data,
                        CONTENT_TYPES.get(ext, "application/octet-stream"))

        def do_POST(self):
            with span("kaamer.request"):
                self._search()

        def _search(self):
            path = urllib.parse.urlparse(self.path).path
            seq_type = ROUTES.get(path)
            if seq_type is None:
                self.send_error(404)
                return
            fields, files = _parse_form(self)
            opts = _default_options(seq_type)
            err = parse_search_options(opts, fields, files, tmp_folder)
            if err:
                self._reply(400, (err + "\n").encode())
                return
            ctype = ("application/json" if opts.OutFormat == "json"
                     else "text/plain;charset=UTF-8")
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            cancel = _disconnect_poller(self.connection)
            try:
                for chunk in run_search(engine, opts, cancel=cancel):
                    if chunk:
                        self.wfile.write(b"%x\r\n" % len(chunk))
                        self.wfile.write(chunk)
                        self.wfile.write(b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass  # client cancelled mid-write
            finally:
                if opts.InputType != "path" and opts.File:
                    try:
                        os.remove(opts.File)
                    except OSError:
                        pass

    return Handler


def make_server(engine: SearchEngine, port: int = 8321, tmp_folder: str = "",
                host: str = "") -> ThreadingHTTPServer:
    """A threading HTTP server bound to (host, port) serving `engine` and
    the static routes (port 0 picks a free port: read server_address)."""
    if not os.path.isdir(tmp_folder):
        tmp_folder = tempfile.gettempdir()
    return ThreadingHTTPServer((host, port),
                               make_handler(engine, tmp_folder, web_dirs()))


def load_engine(db_path: str, device="cuda", n_shards: int = 0):
    """Open a database as a search engine on `device`
    (kaamer_tpu/server/app.py:282-299).  n_shards > 1 serves it from an
    index sharded over a (dp, shard) mesh (parallel/dist.py): of every
    card for device "cuda", else of `device` repeated n_shards times.  A
    shard-built artifact is served sharded whatever n_shards says."""
    print(" + Opening kAAmer Database.. ", end="", flush=True)
    t0 = time.time()
    art = load_db(db_path)
    if getattr(art, "index_shards", 0) and n_shards <= 1:
        # shard-BUILT artifacts (index_db n_shards > 1) have no global
        # index; they can only be served sharded, so auto-select it
        n_shards = art.index_shards
        print(f"[shard-built index: serving sharded x{n_shards}] ",
              end="", flush=True)
    if n_shards > 1:
        from ..parallel.dist import ShardedSearchEngine, global_mesh

        device = torch.device(device)
        devices = None if device == torch.device("cuda") else (
            [device] * n_shards)
        engine = ShardedSearchEngine(art, mesh=global_mesh(n_shards,
                                                           devices))
        # global_mesh reduces the shard count to a divisor of the device
        # count; report what actually happened, not what was asked for
        if engine.n_shards != n_shards:
            print(f"[sharded x{engine.n_shards}; {n_shards} requested but "
                  f"only divisors of the device count are possible] ",
                  end="", flush=True)
        else:
            print(f"[sharded x{engine.n_shards}] ", end="", flush=True)
    else:
        engine = SearchEngine(art, device)
    dt = int(time.time() - t0)
    print(f"done [{dt // 60:02d}m{dt % 60:02d}s] on {engine.device}")
    return engine


def serve(db_path: str, port: int = 8321, device="cuda",
          tmp_folder: str = "/tmp/", n_shards: int = 0) -> None:
    """Load a database onto `device` (load_engine) and serve it, with the
    static routes, until interrupted.  The engine's warmup runs in a
    daemon thread meanwhile (kaamer_tpu/server/app.py:313-316), so that
    the first requests find the serving shapes warm; it prints one line
    when it ends.  An exception it lets through prints its traceback and
    ends that thread, not the server."""
    engine = load_engine(db_path, device, n_shards)
    httpd = make_server(engine, port, tmp_folder)

    def warm():
        t0 = time.time()
        engine.warmup()
        print(f" + serving-shape warmup ended in {time.time() - t0:.1f}s",
              flush=True)

    threading.Thread(target=warm, daemon=True).start()
    print(f" + kaamer-tpu-torch server listening on port {port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
