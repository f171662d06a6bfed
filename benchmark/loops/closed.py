"""A closed loop: send a request, wait for its whole answer, send the
next, while the deadline has not passed.  The requests are made before
the window; past the last one the loop starts again at the first."""

from __future__ import annotations

import time


def run(send, requests, deadline: float):
    records = []
    while time.monotonic() < deadline:
        i = len(records)
        records.append(send(requests[i % len(requests)], i))
    return records
