"""Spans: named host intervals around the phases of the serving step and
the model (``engine.step``, ``step.*``, ``model.*``).

``span(name, **attrs)`` is a context manager that does work only while
``torch.profiler`` runs: it enters a ``_RecordFunctionFast`` range, a
``cpu_op`` event on the profiler's clock among the runtime calls that
launch the phase's kernels, with ``attrs`` as its keyword values (under
``record_shapes=True`` they are the event's ``args`` in an exported
Chrome trace).  Never a user annotation, which kineto would also copy
onto the device's timeline as if it were a kernel.

Otherwise it returns one shared null context after one check.  An attr
given as a zero-argument callable is called once, as the span is made,
so a phase's byte count costs nothing while the profiler is off.  A span
never dispatches a tensor operation.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

__all__ = ["span"]

_NULL = nullcontext()
_profiling = torch.autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str, **attrs):
    """A context manager around one phase of work (see the module's
    docstring); the shared null context while the profiler is off."""
    if not _profiling():
        return _NULL
    return _RecordFunctionFast(
        name, [], {k: v() if callable(v) else v for k, v in attrs.items()})
