"""One server on the wall clock: an open-loop copy of the program's
``RealCluster.run`` loop for a single engine.

Requests are released into per-class queues when due; while the engine
holds no prefill and has a free slot, the occupancy gate (planned by the
bundled LP) picks the class whose head is admitted; then the engine runs
one iteration, mixed when a prefill is staged and solo otherwise. Each
token is stamped when the iteration that produced it returns (the step
ends in a host copy of the tokens). Only public names of the program are
called: ``ServerEngine.{free_slots, has_prefill, n_decoding,
start_prefill, step, activate_slot}``, ``SlotRequest.tokens_out`` and
``OccupancyGate.select``.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Iteration", "Record", "serve"]


@dataclass
class Iteration:
    mode: str  # "mixed" | "solo"
    t0: float
    t1: float
    decode_ctx: list  # context length of each decode token produced
    chunk: tuple = None  # (first position, real tokens) of a mixed step
    lengths: np.ndarray = None  # every slot's length, in traced iterations


@dataclass
class Record:
    """Everything a run saw, on the driver's clock (seconds after the
    traffic started)."""

    requests: list
    open: float  # window
    close: float
    iterations: list = field(default_factory=list)
    admissions: list = field(default_factory=list)  # (waiting, qlen, X, i)
    lateness: list = field(default_factory=list)  # release - due
    traced: tuple = None  # (first, last) index of the iterations profiled
    backlog: list = field(default_factory=list)  # (t, queued), every 0.5 s


class _View:
    """What ``OccupancyGate.select`` reads of one server."""

    def __init__(self, queues, X):
        self.queues, self.X = queues, X

    def prefill_queue_len(self, i):
        return len(self.queues[i])

    def prefill_in_service(self, i):
        return self.X[i]

    def n_servers(self):
        return 1


def serve(engine, gate, slot_request, requests, *, chunk: int, t0: float,
          open_: float, close: float, n_classes: int,
          clock=time.perf_counter, sleep=time.sleep, on_step=None,
          read_lengths=None, span=None) -> Record:
    """Serve ``requests`` (sorted by ``due``; traffic starts at ``t0`` on
    ``clock``) until ``close`` seconds after ``t0``; ``chunk`` is the
    engine's prefill chunk.

    ``slot_request(req)`` makes the program's ``SlotRequest``; ``clock``
    and ``sleep`` are the wall clock's (tests give a virtual one).
    ``on_step(k, rec)``, if given, is called before iteration ``k`` and
    returns True while that iteration is traced; ``read_lengths()`` then
    gives every slot's length before it, and ``span(mode)`` is the
    context the step runs in.
    """
    rec = Record(requests=requests, open=open_, close=close)
    queues = [deque() for _ in range(n_classes)]
    X = np.zeros(n_classes)
    view = _View(queues, X)
    live = {}  # rid -> (Request, SlotRequest) once admitted
    staged = None  # [Request, tokens prefilled] of the engine's prefill
    nxt = 0
    k = 0
    while True:
        now = clock() - t0
        if now >= close:
            break
        while nxt < len(requests) and requests[nxt].due <= now:
            r = requests[nxt]
            r.released = now
            rec.lateness.append(now - r.due)
            queues[r.cls].append(r)
            nxt += 1
        if not engine.has_prefill and engine.free_slots():
            waiting = [i for i in range(n_classes) if queues[i]]
            if waiting:
                i = gate.select(view, waiting)
                if i is not None:
                    rec.admissions.append(
                        (tuple(waiting), tuple(len(q) for q in queues),
                         tuple(X), i))
                    r = queues[i].popleft()
                    sr = slot_request(r)
                    engine.start_prefill(sr, r.prompt)
                    r.admitted = clock() - t0
                    X[i] += 1
                    live[r.rid] = (r, sr)
                    staged = [r, 0]
        if not engine.has_prefill and engine.n_decoding == 0:
            wake = requests[nxt].due if nxt < len(requests) else close
            sleep(max(0.0, min(wake, close) - (clock() - t0)))
            continue
        traced = on_step(k, rec) if on_step else False
        lengths = read_lengths() if traced else None
        mode = "mixed" if engine.has_prefill else "solo"
        piece = None
        if mode == "mixed":
            piece = (staged[1], min(chunk, staged[0].prompt_len - staged[1]))
            staged[1] += piece[1]
        before = {rid: sr.tokens_out for rid, (_, sr) in live.items()}
        ctx = [r.prompt_len + sr.tokens_out + 1
               for r, sr in live.values() if not np.isnan(r.prefilled)]
        s0 = clock() - t0
        with span(mode) if traced and span else nullcontext():
            res = engine.step()
        s1 = clock() - t0
        rec.iterations.append(Iteration(mode, s0, s1, ctx, piece, lengths))
        k += 1
        for rid, (r, sr) in list(live.items()):
            for _ in range(sr.tokens_out - before[rid]):
                r.token_times.append(s1)
        for sr in res["completed"]:
            r, _ = live.pop(sr.rid)
            r.out_tokens = list(sr.out_tokens)
            r.done = True
        if res["prefill_done"] is not None:
            sr = res["prefill_done"]
            engine.activate_slot(res["prefill_slot"])
            r = live[sr.rid][0]
            r.prefilled = s1
            X[r.cls] -= 1
            staged = None
        if not rec.backlog or s1 - rec.backlog[-1][0] >= 0.5:
            rec.backlog.append((s1, sum(len(q) for q in queues)))
    for r, sr in live.values():
        r.out_tokens = list(sr.out_tokens)
    return rec
