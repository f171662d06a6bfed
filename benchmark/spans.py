"""Spans of a traced run.  The benchmark's own wrappers around the calls
into each layer of the program open a torch.profiler.record_function
range named after the layer.  The profiler, run on every thread
(profile_all_threads: a default profiler records only the thread that
started it), keeps each range in its trace on the thread that ran it,
beside the operations that thread ran; each kernel names the operation
that launched it by its External id (tracefile.py):

  do_POST          the server's handler of one request
  run_search       each step of the search pipeline's stream
  engine.<method>  the engine's host methods the pipeline calls
  hot_matmul#<i>   the i-th call of the hot-set product; `calls[i]` holds
                   its logical shapes and the element sizes of W, M and
                   the result
"""

from __future__ import annotations

import functools
import itertools

from torch.profiler import record_function

ENGINE_METHODS = ("dispatch_batch", "schedule_batch", "prefetch_batch",
                  "collect_batch", "resolve_batch", "position_bitmaps_np")
GEMM = "hot_matmul"


class Spans:
    """Installs the wrappers on the program's server module, handler
    class, engine and hot-set module; remove() puts the originals back."""

    def __init__(self, app, hotset, engine, handler_cls):
        self.calls = {}
        self._ids = itertools.count()
        self._undo = []
        self._patch(app, "run_search", self._stream(app.run_search))
        self._patch(handler_cls, "do_POST",
                    self._call(handler_cls.do_POST, "do_POST"))
        self._patch(hotset, GEMM, self._gemm(hotset.hot_matmul))
        for m in ENGINE_METHODS:
            self._patch(engine, m,
                        self._call(getattr(engine, m), f"engine.{m}"),
                        instance=True)

    @staticmethod
    def _call(fn, name: str):
        @functools.wraps(fn)
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    @staticmethod
    def _stream(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            it = fn(*a, **kw)
            try:
                while True:
                    with record_function("run_search"):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    yield item
            finally:
                it.close()
        return call

    def _gemm(self, fn):
        @functools.wraps(fn)
        def call(W, M, *a, **kw):
            i = next(self._ids)
            with record_function(f"{GEMM}#{i}"):
                out = fn(W, M, *a, **kw)
            self.calls[i] = {
                "G": W.shape[0], "H": W.shape[1], "P": M.shape[1],
                "w": W.element_size(), "m": M.element_size(),
                "out": out.element_size()}
            return out
        return call

    def _patch(self, obj, name, new, instance=False):
        old = None if instance else getattr(obj, name)
        setattr(obj, name, new)
        self._undo.append((obj, name, old))

    def remove(self) -> None:
        for obj, name, old in reversed(self._undo):
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)
        self._undo = []
