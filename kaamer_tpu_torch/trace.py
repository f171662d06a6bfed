"""Spans inside the program, on the torch profiler's clock.

    from ..trace import span

    with span("kaamer.engine.plan"):
        ...

span(name) is a torch.profiler record_function range while a torch
profiler runs in this process, and one shared no-op context manager
otherwise: with no profiler the cost is one attribute check a site.  The
profiler's trace is the only sink; the spans land in it beside the
operations and kernels they launched, on one clock.  The check reads
torch.autograd.profiler._is_profiler_enabled, which is True on every
thread while a profile runs; torch.autograd._profiler_enabled() reads
False on a thread other than the profiler's, even where the profiler
records all threads (profile_all_threads), so spans guarded by it would
be lost on the request threads where the work happens.

Rules for the sites:

- Never hold a span open across a `yield`: the consumer's work would
  land inside it.  Build what one batch yields under the span, then
  yield it.
- On the serving path open spans per request, batch, chunk or call, not
  per query, so that a traced run's trace stays small.
- Parentage is nesting on one thread.  A request's identity is its
  `kaamer.request` span on the handler thread: the pipeline and the
  engine run on that thread.  Threads of native code (the ORF scanner's)
  open no spans.
- Every name starts with `kaamer.`.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A record_function range named `name` while a profiler runs, else
    the shared no-op context manager."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
