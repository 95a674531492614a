"""Shared timing helpers (warmup + median-of-reps).

``timeit_median`` times a host callable with the wall clock (the
reference's helper, unchanged).  ``timeit_median_cuda`` times the work a
callable enqueues on the current CUDA stream: the reps are queued behind
a spin kernel, so the card runs them back to back and each CUDA-event
interval holds the card's time for one rep, not the host's time to make
the call.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

__all__ = ["timeit_median", "timeit_median_cuda"]

_SPIN_CYCLES = 1 << 22  # first spin: about 2 ms at 2 GHz
_SPIN_TRIES = 5  # each try spins 4x longer, up to about 0.5 s


def timeit_median(fn: Callable[[], object], *, warmup: int = 2,
                  reps: int = 5) -> float:
    """Median-of-``reps`` wall time of ``fn()`` after ``warmup`` calls.

    ``perf_counter`` is monotonic, and the median discards the GC and
    first-call outliers that a mean would keep.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def timeit_median_cuda(fn: Callable[[], object], *, warmup: int = 2,
                       reps: int = 5) -> float:
    """Median-of-``reps`` device seconds of the work ``fn()`` enqueues.

    After ``warmup`` calls, a spin kernel (``torch.cuda._sleep``) holds
    the current stream while the host queues every rep, each between its
    own pair of CUDA events.  An event recorded right after the spin
    tells whether the host finished queueing before the card reached the
    reps; if not, the spin is lengthened and the reps queued again.  The
    events are read only after ``torch.cuda.synchronize()``.  Raises if
    no spin was long enough, as when ``fn`` waits on the card itself.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = _SPIN_CYCLES
    for _ in range(_SPIN_TRIES):
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        gate = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        gate.record()
        for start, end in marks:
            start.record()
            fn()
            end.record()
        queued_ahead = not gate.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return statistics.median(s.elapsed_time(e) for s, e in marks) / 1e3
        cycles *= 4
    raise RuntimeError(
        f"timeit_median_cuda: the card reached the reps before the host had "
        f"queued them, even behind a spin of {cycles // 4} cycles; does fn "
        f"wait on the card?")
