"""Spans: named host intervals around the phases of the serving step and
the model (``engine.step``, ``step.*``, ``model.*``).

``span(name, **attrs)`` is a context manager that does work in two cases
only:

* while ``torch.profiler`` runs, it enters a ``_RecordFunctionFast``
  range: a ``cpu_op`` event on the profiler's clock, among the runtime
  calls that launch the phase's kernels.  Never a user annotation, which
  kineto would also copy onto the device's timeline as if it were a
  kernel;
* while :func:`recording` is on, it appends ``(name, start_ns, end_ns,
  parent, attrs)`` to an in-memory store on ``time.perf_counter_ns``;
  ``parent`` is the index of the enclosing record, -1 at the top.

Otherwise it returns one shared null context after one check.  An attr
given as a zero-argument callable is called only when the store records,
so a phase's byte count costs nothing while nobody reads it.  A span
never dispatches a tensor operation.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch

__all__ = ["span", "recording", "records", "dropped"]

LIMIT = 1 << 18  # records a window keeps; spans past it are counted
_NULL = nullcontext()
_profiling = torch.autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class _Store:
    """One recorded window: at most ``LIMIT`` records; spans past it are
    counted in ``dropped``."""

    def __init__(self):
        self.on = False
        self.recs: list = []
        self.stack: list = []  # indices of the open records, innermost last
        self.dropped = 0

    def open(self, name: str, attrs: dict):
        if len(self.recs) >= LIMIT:
            self.dropped += 1
            return None
        rec = [name, time.perf_counter_ns(), None,
               self.stack[-1] if self.stack else -1,
               {k: v() if callable(v) else v for k, v in attrs.items()}]
        self.stack.append(len(self.recs))
        self.recs.append(rec)
        return rec

    def close(self, rec: list):
        rec[2] = time.perf_counter_ns()
        if self.stack and self.recs[self.stack[-1]] is rec:
            self.stack.pop()


_STORE = _Store()


class _Span:
    __slots__ = ("name", "attrs", "fast", "rec")

    def __init__(self, name: str, attrs: dict, profiling: bool):
        self.name, self.attrs = name, attrs
        self.fast = _RecordFunctionFast(name) if profiling else None
        self.rec = None

    def __enter__(self):
        if self.fast is not None:
            self.fast.__enter__()
        if _STORE.on:
            self.rec = _STORE.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            _STORE.close(self.rec)
        if self.fast is not None:
            self.fast.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around one phase of work (see the module's
    docstring); the shared null context while neither the profiler nor
    the store is on."""
    profiling = _profiling()
    if not (profiling or _STORE.on):
        return _NULL
    return _Span(name, attrs, profiling)


@contextmanager
def recording():
    """Record every span entered inside the block, in place of the last
    window's records; read them with :func:`records`."""
    _STORE.recs, _STORE.stack, _STORE.dropped = [], [], 0
    _STORE.on = True
    try:
        yield
    finally:
        _STORE.on = False


def records() -> list:
    """The last window's ``(name, start_ns, end_ns, parent, attrs)``
    tuples, in the order the spans were entered."""
    return [tuple(r) for r in _STORE.recs]


def dropped() -> int:
    """Spans the last window entered past ``LIMIT``."""
    return _STORE.dropped
