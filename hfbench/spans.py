"""Host-clock spans around the port's layer entry points, installed by the
benchmark in a traced run only.  Each span synchronises the device at its
edges, so that its interval holds the device work of its layer.

What each span wraps (the private names are a stopgap until the program
records spans of its own):

- ``step``: one optimizer step, from the harness's loop;
- ``precond``: the preconditioner's diagonal and its average, from a step
  driver;
- ``build``: ``optimizer._build_matvec_and_grad`` (loss, gradient and the
  linearized matvec of one batch);
- ``matvec``: the matvec closure that the build returns;
- ``acc_matvec``: the closure that ``accumulate._make_acc_mvp`` returns;
- ``select``: ``optimizer.cg_efficient_backtracking`` and
  ``optimizer._linesearch``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import List, NamedTuple


class Span(NamedTuple):
    name: str
    start: float  # perf_counter seconds
    end: float
    depth: int  # 0 for a span with no open parent


class Tracer:
    def __init__(self, sync):
        self.sync = sync
        self.spans: List[Span] = []
        self._depth = 0
        self._undo = []

    @contextlib.contextmanager
    def span(self, name):
        self.sync()
        start = time.perf_counter()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.sync()
            self.spans.append(Span(name, start, time.perf_counter(),
                                   self._depth))

    def wrap(self, name, fn, returns=None):
        """``fn`` inside a span; ``returns={index: name}`` wraps the
        callables at those positions of its result in spans too."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name):
                out = fn(*args, **kwargs)
            if not returns:
                return out
            out = list(out)
            for i, inner in returns.items():
                out[i] = self.wrap(inner, out[i])
            return tuple(out)

        return wrapped

    def _set(self, module, attr, value):
        self._undo.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    def install(self):
        from pytorchhessianfree_tpu_torch import accumulate, optimizer

        build = optimizer._build_matvec_and_grad
        self._set(optimizer, "_build_matvec_and_grad",
                  self.wrap("build", build, returns={2: "matvec"}))
        make_acc_mvp = accumulate._make_acc_mvp
        self._set(accumulate, "_make_acc_mvp", lambda *a, **k: self.wrap(
            "acc_matvec", make_acc_mvp(*a, **k)))
        for attr in ("cg_efficient_backtracking", "_linesearch"):
            self._set(optimizer, attr,
                      self.wrap("select", getattr(optimizer, attr)))

    def uninstall(self):
        while self._undo:
            module, attr, original = self._undo.pop()
            setattr(module, attr, original)
