"""Search client: builds the multipart POST and streams the response
(the port's copy of kaamer_tpu/server/client.py; reference
pkg/searchcli/searchcli.go:41-122).

One repair against the copy: HTTPError is a subclass of URLError, so the
JAX client's URLError handler also caught every HTTP error status and
printed "No kaamer-db server running" for a server's 400 (a path-mode
query file the server cannot see).  Here the HTTPError handler comes
first and prints the server's message."""

from __future__ import annotations

import io
import sys
import urllib.error
import urllib.request
import uuid

from ..search.options import NUCLEOTIDE, PROTEIN, READS


def _multipart(fields: dict, file_field=None) -> tuple:
    boundary = "kaamer" + uuid.uuid4().hex
    buf = io.BytesIO()
    for k, v in fields.items():
        buf.write(f"--{boundary}\r\n".encode())
        buf.write(f'Content-Disposition: form-data; name="{k}"\r\n\r\n'.encode())
        buf.write(str(v).encode())
        buf.write(b"\r\n")
    if file_field is not None:
        name, filename, data = file_field
        buf.write(f"--{boundary}\r\n".encode())
        buf.write(
            f'Content-Disposition: form-data; name="{name}"; filename="{filename}"\r\n'
            .encode()
        )
        buf.write(b"Content-Type: application/octet-stream\r\n\r\n")
        buf.write(data)
        buf.write(b"\r\n")
    buf.write(f"--{boundary}--\r\n".encode())
    return buf.getvalue(), f"multipart/form-data; boundary={boundary}"


def search_request(
    server_host: str,
    file: str,
    sequence_type: int,
    input_type: str = "path",
    genetic_code: int = 11,
    out_format: str = "tsv",
    max_results: int = 10,
    align: bool = False,
    annotations: bool = False,
    positions: bool = False,
    min_kmatch: int = 10,
    min_kratio: float = 0.05,
    sub_matrix: str = "blosum62",
    gap_open: int = 11,
    gap_extend: int = 1,
    output=None,
):
    """NewSearchRequest equivalent: POST and stream the chunked response."""
    fields = {
        "type": input_type,
        "gcode": genetic_code,
        "output-format": out_format,
        "max-results": max_results,
        "align": "true" if align else "false",
        "annotations": "true" if annotations else "false",
        "positions": "true" if positions else "false",
        "minkmatch": min_kmatch,
        "minkratio": f"{min_kratio:f}",
        "sub-matrix": sub_matrix,
        "gap-open": gap_open,
        "gap-extend": gap_extend,
    }

    route = {PROTEIN: "protein", NUCLEOTIDE: "nucleotide", READS: "fastq"}[
        sequence_type
    ]
    url = f"{server_host}/api/search/{route}"

    file_field = None
    if input_type == "file":
        with open(file, "rb") as f:
            file_field = ("file", file, f.read())
    else:
        fields["file"] = file

    body, ctype = _multipart(fields, file_field)
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    out = output or sys.stdout
    try:
        with urllib.request.urlopen(req) as resp:
            while True:
                chunk = resp.read(65536)
                if not chunk:
                    break
                out.write(chunk.decode("utf-8", errors="replace"))
    except urllib.error.HTTPError as e:
        print(e.read().decode())
        sys.exit(1)
    except urllib.error.URLError:
        print(f"No kaamer-db server running at {server_host}")
        sys.exit(1)
