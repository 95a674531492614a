"""Real-compute cluster: gate-and-route over N ServerEngines.

The control plane is the paper's: a static mixed/solo partition from the
planning LP, the occupancy-deviation prefill gate, and the solo-first
work-conserving decode router -- but every iteration executes *actual*
model compute, and cross-server decode placement performs *actual*
KV migration (extract/inject).  Virtual time advances per server with the
calibrated iteration times, so revenue/latency metrics are those of the
calibrated hardware while token streams are bit-exact.

This is deliberately the main policy only; the policy zoo / baselines run
in :mod:`repro_torch.serving.engine_sim` (same scheduler semantics,
calibrated compute), mirroring the paper's own simulator/hardware split.
The port adds one record the reference does not keep: the host wall time
of every iteration (``ClusterMetrics.iter_wall``, seconds by mode), which
ends in a host copy of the decoded tokens and so covers the device's work.
"""

from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..compat import resolve_device
from ..core.planning import PlanSolution
from ..core.policies import OccupancyGate
from ..core.types import Pricing, ServicePrimitives, WorkloadClass
from ..models.config import ModelConfig

from .engine import ServerEngine, SlotRequest

__all__ = ["RealCluster", "ClusterMetrics"]


@dataclass
class ClusterMetrics:
    revenue: float = 0.0
    completions: int = 0
    arrivals: int = 0
    migrations: int = 0
    horizon: float = 0.0
    per_class_completions: dict = None
    iter_wall: dict = None  # "mixed" / "solo" -> host seconds per iteration

    def summary(self) -> dict:
        return {
            "revenue": self.revenue,
            "revenue_rate": self.revenue / self.horizon if self.horizon else 0,
            "completions": self.completions,
            "arrivals": self.arrivals,
            "kv_migrations": self.migrations,
            "per_class_completions": self.per_class_completions,
        }


class _View:
    def __init__(self, cl):
        self.cl = cl

    def prefill_queue_len(self, i):
        return len(self.cl.prefill_q[i])

    def prefill_in_service(self, i):
        return self.cl.X[i]

    def n_servers(self):
        return len(self.cl.engines)

    def head_of_line_class(self):
        best = None
        best_t = float("inf")
        for i, q in enumerate(self.cl.prefill_q):
            if q and q[0][0] < best_t:
                best_t, best = q[0][0], i
        return best


class RealCluster:
    def __init__(self, cfg: ModelConfig, params, classes: Sequence[WorkloadClass],
                 plan: PlanSolution, prim: ServicePrimitives, pricing: Pricing,
                 n_servers: int, max_len: int, seed: int = 0, device=None):
        self.cfg = cfg
        self.classes = tuple(classes)
        self.I = len(classes)
        self.prim = prim
        self.pricing = pricing
        self.plan = plan
        self.gate = OccupancyGate(plan.x, plan.qp)
        self.view = _View(self)
        M = plan.mixed_servers(n_servers)
        self.groups = ["mixed" if s < M else "solo" for s in range(n_servers)]
        device = resolve_device(device)
        self.engines = [
            ServerEngine(cfg, params, prim=prim, max_len=max_len,
                         seed=seed + s, device=device)
            for s in range(n_servers)
        ]
        self.prefill_q: list[deque] = [deque() for _ in range(self.I)]
        self.decode_buf: deque = deque()  # (req, sub_cache, meta)
        self.X = np.zeros(self.I)
        self.rng = np.random.default_rng(seed)
        self.metrics = ClusterMetrics(per_class_completions={},
                                      iter_wall={"mixed": [], "solo": []})
        self._rid = itertools.count()

    # --------------------------------------------------------------- admit
    def _admit_prefills(self):
        for sid, eng in enumerate(self.engines):
            if self.groups[sid] != "mixed" or eng.has_prefill:
                continue
            if not eng.free_slots():
                continue
            waiting = [i for i in range(self.I) if self.prefill_q[i]]
            if not waiting:
                return
            i = self.gate.select(self.view, waiting)
            if i is None:
                return
            _, req, toks = self.prefill_q[i].popleft()
            eng.start_prefill(req, toks)
            self.X[i] += 1

    def _free_decode_capacity(self, sid: int) -> int:
        cap = (self.prim.batch_cap - 1 if self.groups[sid] == "mixed"
               else self.prim.batch_cap)
        return max(0, cap - self.engines[sid].n_decoding)

    def _dispatch_decodes(self):
        """Solo-first work-conserving placement with real KV injection."""
        while self.decode_buf:
            order = [s for s in range(len(self.engines))
                     if self.groups[s] == "solo"]
            order += [s for s in range(len(self.engines))
                      if self.groups[s] == "mixed"]
            placed = False
            for sid in order:
                eng = self.engines[sid]
                if self._free_decode_capacity(sid) <= 0:
                    continue
                free = eng.free_slots()
                if not free:
                    continue
                req, sub, meta, src = self.decode_buf.popleft()
                eng.inject_slot(free[0], req, sub, meta)
                if src != sid:
                    self.metrics.migrations += 1
                placed = True
                break
            if not placed:
                return

    # ----------------------------------------------------------------- run
    def run(self, requests, horizon: float) -> ClusterMetrics:
        """``requests``: iterable of (t_arrival, cls, prompt_tokens, D)."""
        heap = []
        ctr = itertools.count()
        for (t, cls, toks, D) in requests:
            heapq.heappush(heap, (t, next(ctr), "arrival", (cls, toks, D)))
        for sid in range(len(self.engines)):
            heapq.heappush(heap, (0.0, next(ctr), "iter", sid))
        now = 0.0
        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            if t > horizon:
                break
            now = t
            if kind == "arrival":
                cls, toks, D = payload
                req = SlotRequest(rid=next(self._rid), cls=cls,
                                  prompt_len=len(toks), decode_len=D)
                self.prefill_q[cls].append((t, req, np.asarray(toks)))
                self.metrics.arrivals += 1
                self._admit_prefills()
            else:  # server iteration boundary
                sid = payload
                eng = self.engines[sid]
                if not eng.has_prefill and eng.n_decoding == 0:
                    # idle; poll again shortly (cheap virtual-time tick)
                    self._admit_prefills()
                    if eng.has_prefill or eng.n_decoding:
                        heapq.heappush(heap, (now, next(ctr), "iter", sid))
                    else:
                        heapq.heappush(
                            heap, (now + self.prim.tau_solo, next(ctr),
                                   "iter", sid))
                    continue
                mode = "mixed" if eng.has_prefill else "solo"
                t0 = time.perf_counter()
                res = eng.step()
                self.metrics.iter_wall[mode].append(time.perf_counter() - t0)
                for req in res["completed"]:
                    self.metrics.completions += 1
                    self.metrics.per_class_completions[req.cls] = (
                        self.metrics.per_class_completions.get(req.cls, 0) + 1)
                    self.metrics.revenue += self.pricing.bundled_reward(
                        self.classes[req.cls])
                if res["prefill_done"] is not None:
                    req = res["prefill_done"]
                    self.X[req.cls] -= 1
                    # extract the prefilled KV and route via the buffer
                    r2, sub, meta = eng.extract_slot(res["prefill_slot"])
                    assert r2 is req
                    self.decode_buf.append((req, sub, meta, sid))
                    self._dispatch_decodes()
                self._admit_prefills()
                heapq.heappush(
                    heap, (now + max(res["tau"], 1e-9), next(ctr), "iter", sid))
        self.metrics.horizon = min(now, horizon)
        return self.metrics
