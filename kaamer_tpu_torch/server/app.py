"""HTTP API server on the torch engine (kaamer_tpu/server/app.py).

  GET  /api/dbinfo              -> KStats JSON
  POST /api/search/protein      -> streamed TSV/JSON, form fields as the
                                   JAX server's (parse_search_options)
  POST /api/search/{nucleotide,fastq} -> 501 (not ported yet)

Form parsing, option parsing and the disconnect poller are the JAX
server's; the handler is this module's own because the JAX make_handler
calls the JAX package's run_search.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kaamer_tpu.index.artifact import load_db
from kaamer_tpu.search.options import PROTEIN
from kaamer_tpu.server.app import (_default_options, _disconnect_poller,
                                   _parse_form, parse_search_options)

from ..search.engine import SearchEngine
from ..search.pipeline import run_search

_NOT_PORTED = ("/api/search/nucleotide", "/api/search/fastq")


def make_handler(engine: SearchEngine, tmp_folder: str):
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
            if path == "/api/dbinfo":
                self._reply(200, json.dumps(db_stats.to_json_obj()).encode(),
                            "application/json")
                return
            self.send_error(404)

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            if path in _NOT_PORTED:
                _parse_form(self)  # drain the body of the kept-alive request
                self._reply(501, f"{path}: not ported yet\n".encode())
                return
            if path != "/api/search/protein":
                self.send_error(404)
                return
            fields, files = _parse_form(self)
            opts = _default_options(PROTEIN)
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
    """A threading HTTP server bound to (host, port) serving `engine`
    (port 0 picks a free port: read server_address)."""
    if not os.path.isdir(tmp_folder):
        tmp_folder = tempfile.gettempdir()
    return ThreadingHTTPServer((host, port), make_handler(engine, tmp_folder))


def serve(db_path: str, port: int = 8321, device="cuda",
          tmp_folder: str = "") -> None:
    """Load a database onto `device` and serve it until interrupted."""
    print(" + Opening kAAmer Database.. ", end="", flush=True)
    t0 = time.time()
    engine = SearchEngine(load_db(db_path), device)
    dt = int(time.time() - t0)
    print(f"done [{dt // 60:02d}m{dt % 60:02d}s] on {engine.device}")
    httpd = make_server(engine, port, tmp_folder)
    print(f" + kaamer-tpu-torch server listening on port {port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
