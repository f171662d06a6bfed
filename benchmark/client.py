"""One client of a traffic mix, run as its own process by the harness:

    python -m benchmark.client '<json: mix, db, seed, client>'

It makes every request it may send in the window (`loop.prepared` of
them, generate.py) and its unmeasured one from the database's cached
residues (database.py), prints `made`, and waits for a line `serve
<port>` on standard input.  It sends the unmeasured request to that port,
prints `ready`, and waits for a line `go <deadline>` (a time.monotonic()
reading, which every process on the host shares).  Then the mix's loop
(`loops/<kind>.py`) sends the requests until the deadline, and the client
prints one JSON line: each request it sent, with when it was sent and
answered, whether the answer was whole, the received rows of the
request's judged records, and the CPU seconds the client used from `go`
to the last answer.

Imports numpy and the standard library only.
"""

from __future__ import annotations

import http.client
import json
import resource
import sys
import time
import uuid

from . import registry
from .database import Database
from .generate import WARM_INDEX, make_request


def multipart(fields: dict, text: str):
    """A multipart/form-data body uploading `text` as the field `file`
    (type=file), with the mix's other form fields."""
    boundary = uuid.uuid4().hex
    parts = []
    for k, v in [("type", "file")] + sorted(fields.items()):
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"\r\n\r\n{v}\r\n'.encode())
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="file"; filename="query"\r\nContent-Type: '
                 f'application/octet-stream\r\n\r\n'.encode())
    parts.append(text.encode())
    parts.append(f"\r\n--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def post(port: int, route: str, body: bytes, ctype: str, timeout: float):
    """(status, body) of one POST to the server on this host."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", route, body, {"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def sampled_rows(text: str, names, sample):
    """The rows of the judged records in a TSV body, by record."""
    want = {names[i]: i for i in sample}
    got = {i: [] for i in sample}
    for line in text.splitlines(keepends=True)[1:]:
        i = want.get(line.split("\t", 1)[0])
        if i is not None:
            got[i].append(line)
    return got


class Sender:
    """Sends prepared requests (generate.Request with its multipart body)
    to the server and records each."""

    def __init__(self, mix: dict, port: int, timeout: float = 600):
        self.mix, self.port, self.timeout = mix, port, timeout

    def __call__(self, prepared, index: int) -> dict:
        req, body, ctype = prepared
        t0 = time.monotonic()
        rec = {"index": index, "t0": t0, "n": len(req.names),
               "ok": False, "sample": []}
        try:
            status, data = post(self.port, self.mix["route"], body, ctype,
                                self.timeout)
            rec["status"] = status
            rec["bytes"] = len(data)
            rec["ok"] = status == 200
        except (OSError, http.client.HTTPException) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            data = b""
        rec["t1"] = time.monotonic()
        got = (sampled_rows(data.decode(), req.names, req.sample)
               if rec["ok"] else {})
        # an answer that never came leaves its judged records without rows
        rec["sample"] = [{"name": req.names[i], "seq": req.seqs[i],
                          "rows": got.get(i)} for i in req.sample]
        return rec


def prepare(mix, db, seed: int, client: int, index: int):
    req = make_request(mix, db, seed, client, index)
    return (req,) + multipart(mix.get("fields", {}), req.text)


def cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def expect(word: str):
    line = sys.stdin.readline().split()
    if not line or line[0] != word:
        raise SystemExit(f"expected {word!r} on standard input, got {line}")
    return line[1]


def main(argv=None) -> int:
    args = json.loads((argv or sys.argv[1:])[0])
    mix, seed, client = args["mix"], args["seed"], args["client"]
    db = Database(args["db"])
    loop = registry.loop(mix["loop"]["kind"])
    requests = [prepare(mix, db, seed, client, i)
                for i in range(int(mix["loop"]["prepared"]))]
    warm = prepare(mix, db, seed, client, WARM_INDEX)
    print("made", flush=True)
    send = Sender(mix, int(expect("serve")))
    rec = send(warm, -1)
    if not rec["ok"]:
        print(f"client {client}: the unmeasured request failed: {rec}",
              file=sys.stderr, flush=True)
        return 1
    print("ready", flush=True)
    deadline = float(expect("go"))
    cpu0 = cpu_s()
    records = loop.run(send, requests, deadline)
    print(json.dumps({"client": client, "records": records,
                      "cpu_s": cpu_s() - cpu0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
