"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a
bounded run of iterations, read as raw kineto events (building the event
tree would take seconds per thousand events), and reduced to kernel
intervals, iteration ranges and host ops. The tracer is always stopped
before the process ends: one left running crashes it at exit."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

__all__ = ["Tracer", "busy_in", "union", "breakdown"]

NAME_CHARS = 160  # a kernel's templated name, cut to stay readable


class Tracer:
    """Profiles the iterations that start from ``first_t`` (seconds on the
    driver's clock) to the end of the window; the tracer stops, and its
    events are read, once the window has closed."""

    def __init__(self, torch, first_t: float):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.first_t = torch, first_t
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.first = None
        self.running = False
        self.wall = 0.0
        self.events = {"kernels": [], "ranges": [], "host": []}

    def warm(self, fn):
        """One profiled call in set-up, so the tracer's own start-up
        does not land in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()
            self.torch.cuda.synchronize()

    def on_step(self, k: int, rec) -> bool:
        """Before iteration ``k``: True while iteration ``k`` is traced."""
        if self.first is None and rec.iterations \
                and rec.iterations[-1].t1 >= self.first_t:
            self.torch.cuda.synchronize()
            self.prof.start()
            self.running = True
            self.first = k
            self.wall = -time.perf_counter()
        return self.running

    def stop(self, rec=None):
        if self.running:
            self.torch.cuda.synchronize()
            self.wall += time.perf_counter()
            self.prof.stop()
            self.running = False
            self.events = self._read()
            if rec is not None:
                rec.traced = (self.first, len(rec.iterations) - 1)

    def _read(self) -> dict:
        from torch.autograd import DeviceType

        raw = self.prof.profiler.kineto_results.events()
        if not raw:
            return {"kernels": [], "ranges": [], "host": []}
        t00 = min(e.start_ns() for e in raw)
        ev = [(e.name(), e.device_type(), (e.start_ns() - t00) / 1e3,
               (e.end_ns() - t00) / 1e3) for e in raw]
        return {
            "kernels": sorted(((n, a, b) for n, dt, a, b in ev
                               if dt == DeviceType.CUDA
                               and not n.startswith("iteration.")),
                              key=lambda x: x[1]),
            "ranges": sorted(((n.split(".", 1)[1], a, b) for n, dt, a, b in ev
                              if dt == DeviceType.CPU
                              and n.startswith("iteration.")),
                             key=lambda x: x[1]),
            "host": [(n, a, b) for n, dt, a, b in ev
                     if dt == DeviceType.CPU
                     and not n.startswith("iteration.")],
        }


def union(intervals) -> float:
    """Length covered by (start, end) intervals."""
    tot, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        tot += b - max(a, end)
        end = b
    return tot


def busy_in(kernels, ranges) -> float:
    """Device time of ``kernels`` (start, end) inside ``ranges`` (sorted,
    disjoint (start, end)), in the intervals' unit."""
    starts = [r[0] for r in ranges]
    busy = 0.0
    for k0, k1 in kernels:
        i = bisect.bisect_right(starts, k0) - 1
        for r0, r1 in ranges[max(i, 0):i + 2]:
            busy += max(0.0, min(k1, r1) - max(k0, r0))
    return busy


def breakdown(events: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    between kernels by the innermost host op running at the gap's
    middle, each as [[name, seconds], ...]."""
    by_op = defaultdict(float)
    for n, a, b in events["kernels"]:
        by_op[n[:NAME_CHARS]] += (b - a) / 1e6
    host = sorted(events["host"], key=lambda x: x[1])
    hstarts = [h[1] for h in host]
    gaps = defaultdict(float)
    end = None
    for n, a, b in events["kernels"]:
        if end is not None and a > end:
            mid = (a + end) / 2
            i = bisect.bisect_right(hstarts, mid)
            # innermost: the latest-starting host op still running at mid
            name = next((host[j][0] for j in range(i - 1, max(i - 200, -1),
                                                   -1)
                         if host[j][2] >= mid), "host, outside any op")
            gaps[name[:NAME_CHARS]] += (a - end) / 1e6
        end = b if end is None else max(end, b)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(gaps)}
