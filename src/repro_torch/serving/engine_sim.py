"""Per-server iteration-level cluster engine (the paper's "calibrated
scheduling simulator", Section 6.2).

Each logical server advances in *iterations*: a mixed iteration (one prefill
chunk of up to C tokens + up to B-1 decode streams) takes
``tau_mix(chunk) = alpha + beta * chunk`` seconds; a decode-only iteration
takes ``tau_solo(K) = a_s + b_s * K`` seconds (K = resident KV tokens; the
second-order KV slope of Fig. 3).  Requests are replayed from a trace or
sampled; the scheduler hooks implement the full policy zoo:

* gate-and-route / prioritize-and-route / SLI-aware (randomized) routers,
* EC.8.6 ablations (immediate & local-FCFS routers, no static planning),
* vLLM-style (prefill-first, *unchunked* prompt processing, local decode),
* Sarathi-style (decode-first token budget: chunk shrinks with co-resident
  decodes, local decode),
* DistServe best fixed splits (mix/solo and prefill/solo).

The engine also models server failures/recoveries and stragglers, and drives
the online controller (rolling-window replanning, elastic capacity).
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.online import OnlineController
from repro_torch.core.policies import PolicySpec
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass
from repro_torch.data.traces import Request
from repro_torch.telemetry.probes import PyProbes, resolve_probe_spec

__all__ = ["EngineConfig", "EngineMetrics", "ClusterEngine"]


@dataclass(frozen=True)
class EngineConfig:
    prim: ServicePrimitives
    pricing: Pricing
    n_servers: int
    solo_kv_slope: float = 1.08e-7  # b_s (s per resident KV token)
    vllm_unchunked: bool = False  # process whole remaining prompt per iter
    sarathi_budget: bool = False  # decode-first chunk budget
    seed: int = 0
    record_queues_every: float = 0.0
    # Optional calibrated IterationTimeModel (repro_torch.calibration.models
    # protocol).  None keeps the historical inline arithmetic untouched;
    # when set, tau_mix/tau_solo come from the model instead of
    # (prim, solo_kv_slope).
    iter_model: Optional[object] = None
    # Optional probe config (None/True/dict/repro_torch.telemetry.ProbeSpec).
    # None keeps the engine untouched; otherwise a PyProbes collector
    # mirrors the device tlm_* arrays and ``metrics.telemetry`` /
    # ``lifecycle_records()`` are populated after ``run``.
    telemetry: Optional[object] = None
    # Optional heterogeneous fleet (repro_torch.core.hetero.FleetSpec).  None
    # keeps every server on (prim, solo_kv_slope) with zero KV-transfer
    # cost; when set, each server gets its class's time surfaces and KV
    # handoff charge (fleet.n must equal n_servers; B/chunk stay
    # fleet-uniform from ``prim``).  Mutually exclusive with iter_model.
    fleet: Optional[object] = None


@dataclass
class _Job:
    req: Request
    prefill_left: int
    tokens_out: int = 0
    server: int = -1
    t_admit: float = float("nan")
    t_prefill_done: float = float("nan")
    t_first_token: float = float("nan")
    t_last_token: float = float("nan")
    pool: str = ""  # randomized router pool assignment ("solo"/"mixed")


@dataclass
class _Server:
    sid: int
    group: str  # "mixed" | "solo"
    target_group: str
    prefill: Optional[_Job] = None
    decodes: list = field(default_factory=list)
    pending_local: deque = field(default_factory=deque)  # immediate-router waits
    speed: float = 1.0
    alive: bool = True
    busy: bool = False  # an iteration is in flight
    iter_decodes: list = field(default_factory=list)  # snapshot at wake
    iter_chunk: int = 0
    # per-server time surfaces (class-resolved under EngineConfig.fleet;
    # copies of the uniform cfg values otherwise)
    alpha: float = 0.0
    beta: float = 0.0
    tau_solo: float = 0.0
    b_s: float = 0.0
    kv_xfer: float = 0.0  # KV handoff seconds per prompt token
    # link bandwidth fraction: 1.0 nominal, < 1 degraded (the "degrade"
    # capacity event); the handoff charge divides by it
    link_scale: float = 1.0

    def kv_tokens(self) -> int:
        k = sum(j.req.prompt_len + j.tokens_out for j in self.decodes)
        if self.prefill is not None:
            k += self.prefill.req.prompt_len - self.prefill.prefill_left
        return k


@dataclass
class EngineMetrics:
    horizon: float = 0.0
    revenue: float = 0.0
    arrivals: int = 0
    completions: int = 0
    abandons: int = 0
    n_iters: int = 0  # completed server iterations (throughput accounting)
    ttft: list = field(default_factory=list)
    tpot: list = field(default_factory=list)
    revenue_t: list = field(default_factory=list)  # (t, cumulative revenue)
    per_class_completions: dict = field(default_factory=dict)
    per_class_arrivals: dict = field(default_factory=dict)
    queue_trace: list = field(default_factory=list)
    # extract_probes() report when the engine ran with telemetry on;
    # never read by summary(), so summaries stay telemetry-invariant
    telemetry: Optional[dict] = None

    def revenue_rate(self) -> float:
        return self.revenue / self.horizon if self.horizon > 0 else 0.0

    def completion_rate(self) -> float:
        return self.completions / self.arrivals if self.arrivals else 0.0

    def summary(self) -> dict:
        def pct(v, q):
            return float(np.percentile(v, q)) if v else float("nan")

        return {
            "revenue_rate": self.revenue_rate(),
            "completion_rate": self.completion_rate(),
            "ttft_mean": float(np.mean(self.ttft)) if self.ttft else float("nan"),
            "ttft_p95": pct(self.ttft, 95),
            "ttft_p99": pct(self.ttft, 99),
            "tpot_mean": float(np.mean(self.tpot)) if self.tpot else float("nan"),
            "tpot_p95": pct(self.tpot, 95),
            "tpot_p99": pct(self.tpot, 99),
            "completions": self.completions,
            "arrivals": self.arrivals,
            "abandons": self.abandons,
        }


class _GateViewEngine:
    def __init__(self, eng: "ClusterEngine"):
        self.eng = eng

    def prefill_queue_len(self, i: int) -> int:
        return len(self.eng.prefill_q[i])

    def prefill_in_service(self, i: int) -> float:
        return self.eng.X[i]

    def n_servers(self) -> int:
        return self.eng.n_alive

    def head_of_line_class(self) -> Optional[int]:
        best_t, best_i = float("inf"), None
        for i, q in enumerate(self.eng.prefill_q):
            if q and q[0].req.t_arrival < best_t:
                best_t, best_i = q[0].req.t_arrival, i
        return best_i


class ClusterEngine:
    """Event-driven per-server engine."""

    def __init__(
        self,
        classes: Sequence[WorkloadClass],
        policy: PolicySpec,
        cfg: EngineConfig,
        controller: Optional[OnlineController] = None,
    ):
        self.classes = tuple(classes)
        self.I = len(self.classes)
        self.policy = policy
        self.cfg = cfg
        self.prim = cfg.prim
        self.pricing = cfg.pricing
        self.rng = np.random.default_rng(cfg.seed)
        self.controller = controller
        self.view = _GateViewEngine(self)

        n = cfg.n_servers
        M = policy.mixed_target(n)
        self.servers = [
            _Server(s, "mixed" if s < M else "solo",
                    "mixed" if s < M else "solo")
            for s in range(n)
        ]
        if cfg.fleet is not None:
            if cfg.iter_model is not None:
                raise ValueError("EngineConfig.fleet and iter_model are "
                                 "mutually exclusive")
            if cfg.fleet.n != n:
                raise ValueError(
                    f"fleet has {cfg.fleet.n} servers but n_servers={n}")
            fp = cfg.fleet.server_params(cfg.prim)
            for s, srv in enumerate(self.servers):
                srv.alpha = float(fp["alpha"][s])
                srv.beta = float(fp["beta"][s])
                srv.tau_solo = float(fp["tau_solo"][s])
                srv.b_s = float(fp["b_s"][s])
                srv.kv_xfer = float(fp["kv_xfer"][s])
        else:
            for srv in self.servers:
                srv.alpha = cfg.prim.alpha
                srv.beta = cfg.prim.beta
                srv.tau_solo = cfg.prim.tau_solo
                srv.b_s = cfg.solo_kv_slope
        self.prefill_q: list[deque] = [deque() for _ in range(self.I)]
        self.decode_buf: deque = deque()  # FCFS (single logical buffer)
        self.decode_buf_solo: deque = deque()  # randomized-router pools
        self.decode_buf_mixed: deque = deque()
        self.X = np.zeros(self.I)  # prefills in service per class
        self.metrics = EngineMetrics()
        self._heap: list = []
        self._counter = itertools.count()
        self._now = 0.0
        self._probes: Optional[PyProbes] = None
        self._jobs: list = []  # lifecycle records (telemetry runs only)

    # ------------------------------------------------------------------ utils
    @property
    def n_alive(self) -> int:
        return sum(1 for s in self.servers if s.alive)

    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._heap, (t, next(self._counter), kind, payload))

    def _decode_cap(self, srv: _Server) -> int:
        B = self.prim.batch_cap
        if self.policy.partition == "none":
            return B - (1 if srv.prefill is not None else 0)
        if srv.group == "mixed":
            if self.policy.prefill_only_mixed:
                return 0
            # paper Section 4.1: "permanently reserves one slot for prefill
            # (or equivalently, prioritize new prefill over decode jobs)" --
            # we implement the work-conserving equivalent: the slot is used
            # by decode while no prefill is active, and prefill admission
            # takes priority as soon as one frees.
            return B - (1 if srv.prefill is not None else 0)
        return B

    def _can_prefill(self, srv: _Server) -> bool:
        if not srv.alive or srv.prefill is not None:
            return False
        if self.policy.partition == "none":
            ok = len(srv.decodes) + len(srv.pending_local) < self.prim.batch_cap
            if self.cfg.sarathi_budget:
                # decode-first: keep headroom so the finished prefill can decode
                ok = ok and len(srv.decodes) < self.prim.batch_cap - 1
            return ok
        if srv.group != "mixed":
            return False
        if self.policy.router == "immediate":
            return len(srv.decodes) + len(srv.pending_local) < self._decode_cap(srv)
        # prefill takes the slot it shares with decode: need one slot free
        # (prefill-priority admission retries at each decode completion)
        return len(srv.decodes) <= self.prim.batch_cap - 1

    # ------------------------------------------------------------ revenue
    def _credit(self, amount: float):
        self.metrics.revenue += amount
        self.metrics.revenue_t.append((self._now, self.metrics.revenue))

    # ------------------------------------------------------------ scheduling
    def _expire_queue(self, q: deque) -> None:
        while q and self._now - q[0].req.t_arrival > q[0].req.patience:
            q.popleft()
            self.metrics.abandons += 1

    def _admit_prefills(self) -> None:
        gate = self.policy.gate
        for srv in self.servers:
            if not self._can_prefill(srv):
                continue
            for q in self.prefill_q:
                self._expire_queue(q)
            waiting = [i for i in range(self.I) if self.prefill_q[i]]
            if not waiting:
                return
            i = gate.select(self.view, waiting)
            if i is None:
                return
            job = self.prefill_q[i].popleft()
            srv.prefill = job
            job.server = srv.sid
            job.t_admit = self._now
            self.X[i] += 1
            if self._probes is not None:
                self._probes.count(self._now, admit_class=i)
            self._wake(srv)

    def _free_slots(self, srv: _Server) -> int:
        return self._decode_cap(srv) - len(srv.decodes)

    def _place_decode(self, job: _Job, srv: _Server) -> None:
        srv.decodes.append(job)
        job.server = srv.sid
        self._wake(srv)

    def _dispatch_decodes(self) -> None:
        """Fill free decode slots from buffers per the router discipline."""
        pol = self.policy
        if pol.router == "randomized":
            for pool, buf, wkey in (
                ("solo", self.decode_buf_solo, "pool_weights_solo"),
                ("mixed", self.decode_buf_mixed, "pool_weights_mixed"),
            ):
                servers = [
                    s for s in self.servers
                    if s.alive and s.group == pool and self._free_slots(s) > 0
                ]
                w = getattr(pol, wkey)
                while servers and buf:
                    job = self._pick_from_buffer(buf, w)
                    if job is None:
                        break
                    srv = servers[int(self.rng.integers(len(servers)))]
                    self._place_decode(job, srv)
                    servers = [s for s in servers if self._free_slots(s) > 0]
            return
        buf = self.decode_buf
        if not buf:
            return
        if pol.router == "solo_first":
            order = [s for s in self.servers if s.alive and s.group == "solo"]
            order += [s for s in self.servers if s.alive and s.group == "mixed"]
        else:  # local_fcfs and the no-partition ablations: any free slot
            order = [s for s in self.servers if s.alive]
        for srv in order:
            while buf and self._free_slots(srv) > 0:
                job = buf.popleft()
                if np.isfinite(job.req.patience) and (
                    self._now - job.t_prefill_done > job.req.patience
                ):
                    self.metrics.abandons += 1
                    continue
                self._place_decode(job, srv)
            if not buf:
                break

    def _pick_from_buffer(self, buf: deque, weights) -> Optional[_Job]:
        while buf:
            if weights is None:
                job = buf.popleft()
            else:
                # EC.7 general policy: class-weighted selection among waiting
                present = {}
                for k, j in enumerate(buf):
                    present.setdefault(j.req.cls, k)
                cls_ids = list(present)
                w = np.array([max(weights[c], 0.0) for c in cls_ids])
                if w.sum() <= 0:
                    job = buf.popleft()
                else:
                    c = cls_ids[int(self.rng.choice(len(cls_ids), p=w / w.sum()))]
                    idx = present[c]
                    buf.rotate(-idx)
                    job = buf.popleft()
                    buf.rotate(idx)
            if np.isfinite(job.req.patience) and (
                self._now - job.t_prefill_done > job.req.patience
            ):
                self.metrics.abandons += 1
                continue
            return job
        return None

    def _route_finished_prefill(self, job: _Job, srv: _Server) -> None:
        pol = self.policy
        if pol.charging == "separate":
            self._credit(self.pricing.c_p * job.req.prompt_len)
        job.t_prefill_done = self._now
        if pol.router == "immediate":
            if self._free_slots(srv) > 0:
                self._place_decode(job, srv)
            else:
                srv.pending_local.append(job)
            return
        if pol.router == "randomized":
            p = float(pol.solo_prob[job.req.cls])
            if self.rng.random() <= p:
                job.pool = "solo"
                self.decode_buf_solo.append(job)
            else:
                job.pool = "mixed"
                self.decode_buf_mixed.append(job)
        else:
            self.decode_buf.append(job)
        self._dispatch_decodes()

    # ------------------------------------------------------------ iterations
    def _iteration_time(self, srv: _Server) -> float:
        m = self.cfg.iter_model
        if m is not None:
            if srv.prefill is not None and srv.iter_chunk > 0:
                return m.tau_mix(srv.iter_chunk) * srv.speed
            return m.tau_solo(srv.kv_tokens()) * srv.speed
        if srv.prefill is not None and srv.iter_chunk > 0:
            t = (srv.alpha + srv.beta * srv.iter_chunk) * srv.speed
            if srv.kv_xfer > 0.0 and srv.iter_chunk >= srv.prefill.prefill_left:
                # finishing chunk: the KV cache ships to the decode pool
                # and occupies the server for bytes-over-bandwidth seconds
                # (link time -- NOT scaled by compute speed, but divided
                # by the link's current bandwidth fraction).
                t += (srv.kv_xfer / srv.link_scale) * srv.prefill.req.prompt_len
            return t
        k = srv.kv_tokens()
        return (srv.tau_solo + srv.b_s * k) * srv.speed

    def _chunk_for(self, srv: _Server) -> int:
        left = srv.prefill.prefill_left
        if self.cfg.vllm_unchunked:
            return left
        if self.cfg.sarathi_budget:
            budget = self.prim.chunk - len(srv.decodes)
            return max(0, min(left, budget))
        return min(left, self.prim.chunk)

    def _wake(self, srv: _Server) -> None:
        if srv.busy or not srv.alive:
            return
        if srv.prefill is None and not srv.decodes:
            return  # idle; woken on assignment
        srv.busy = True
        # Snapshot this iteration's participants: jobs joining mid-iteration
        # wait for the next iteration boundary (continuous batching semantics).
        srv.iter_decodes = list(srv.decodes)
        srv.iter_chunk = self._chunk_for(srv) if srv.prefill is not None else 0
        self._push(self._now + self._iteration_time(srv), "iter", srv.sid)

    def _finish_iteration(self, srv: _Server) -> None:
        srv.busy = False
        if not srv.alive:
            return
        self.metrics.n_iters += 1
        # 1) decode streams emit one token each (snapshot participants only)
        done = []
        for job in srv.iter_decodes:
            job.tokens_out += 1
            if np.isnan(job.t_first_token):
                job.t_first_token = self._now
                self.metrics.ttft.append(self._now - job.req.t_arrival)
                if self._probes is not None:
                    self._probes.observe_ttft(self._now - job.req.t_arrival)
            job.t_last_token = self._now
            if job.tokens_out >= job.req.decode_len:
                done.append(job)
        for job in done:
            srv.decodes.remove(job)
            self.metrics.completions += 1
            if self._probes is not None:
                self._probes.observe_e2e(self._now - job.req.t_arrival)
            self.metrics.per_class_completions[job.req.cls] = (
                self.metrics.per_class_completions.get(job.req.cls, 0) + 1
            )
            if job.req.decode_len > 1:
                self.metrics.tpot.append(
                    (job.t_last_token - job.t_first_token)
                    / (job.req.decode_len - 1)
                )
            if self.policy.charging == "separate":
                self._credit(self.pricing.c_d * job.req.decode_len)
            else:
                self._credit(
                    self.pricing.c_p * job.req.prompt_len
                    + self.pricing.c_d * job.req.decode_len
                )
        # 2) prefill chunk progress
        if srv.prefill is not None:
            job = srv.prefill
            if srv.iter_chunk > 0:
                job.prefill_left -= srv.iter_chunk
            if job.prefill_left <= 0:
                srv.prefill = None
                self.X[job.req.cls] -= 1
                self._route_finished_prefill(job, srv)
        # 3) local pending decode starts (immediate router)
        while srv.pending_local and self._free_slots(srv) > 0:
            self._place_decode(srv.pending_local.popleft(), srv)
        # 4) group flips (non-preemptive replanning)
        if srv.target_group != srv.group and srv.prefill is None:
            if srv.target_group == "solo" or len(srv.decodes) <= (
                self.prim.batch_cap - 1
            ):
                srv.group = srv.target_group
        # 5) refill work
        self._dispatch_decodes()
        self._admit_prefills()
        self._wake(srv)

    # ------------------------------------------------------------ control
    def set_mixed_target(self, m: int) -> None:
        """Retarget the mixed/solo split (online replanning, Eq. 51)."""
        alive = [s for s in self.servers if s.alive]
        mixed = [s for s in alive if s.target_group == "mixed"]
        solo = [s for s in alive if s.target_group == "solo"]
        if len(mixed) > m:
            # prefer flipping servers without an active prefill
            mixed.sort(key=lambda s: (s.prefill is not None, len(s.decodes)))
            for s in mixed[: len(mixed) - m]:
                s.target_group = "solo"
                if s.prefill is None:
                    s.group = "solo"
        elif len(mixed) < m:
            solo.sort(key=lambda s: len(s.decodes))
            for s in solo[: m - len(mixed)]:
                s.target_group = "mixed"
                if len(s.decodes) <= self.prim.batch_cap - 1:
                    s.group = "mixed"
        self._dispatch_decodes()
        self._admit_prefills()

    def fail_server(self, sid: int) -> None:
        srv = self.servers[sid]
        if not srv.alive:
            return
        srv.alive = False
        # active prefill loses progress; decodes lose KV -> re-prefill
        if srv.prefill is not None:
            j = srv.prefill
            j.prefill_left = j.req.prompt_len
            self.X[j.req.cls] -= 1
            self.prefill_q[j.req.cls].appendleft(j)
            srv.prefill = None
        for j in srv.decodes:
            j.prefill_left = j.req.prompt_len
            j.tokens_out = 0
            self.prefill_q[j.req.cls].appendleft(j)
        srv.decodes.clear()
        while srv.pending_local:
            self.decode_buf.append(srv.pending_local.popleft())
        if self.controller is not None:
            self.controller.set_capacity(self.n_alive, self._now)
            self.set_mixed_target(self.controller.mixed_target())

    def recover_server(self, sid: int) -> None:
        srv = self.servers[sid]
        srv.alive = True
        # rejoin in the group the plan targets (a controller may retarget
        # immediately below); never clobber target_group.
        srv.group = srv.target_group
        if self.controller is not None:
            self.controller.set_capacity(self.n_alive, self._now)
            self.set_mixed_target(self.controller.mixed_target())
        self._dispatch_decodes()
        self._admit_prefills()

    def set_straggler(self, sid: int, speed: float) -> None:
        self.servers[sid].speed = speed

    def set_link(self, sid: int, scale: float) -> None:
        """Degrade/restore one server's KV handoff link (capacity
        "degrade" event): ``scale`` is the remaining bandwidth fraction
        (1.0 restores nominal).  Unlike fail/recover the server count is
        unchanged, so the controller replans directly -- transfer-adjusted
        service rates shift even though capacity does not."""
        if scale <= 0 or not np.isfinite(scale):
            raise ValueError(f"link scale must be positive, got {scale}")
        self.servers[sid].link_scale = float(scale)
        if self.controller is not None:
            self._publish_plan(self.controller.replan(self._now))

    def _publish_plan(self, plan) -> None:
        """Push a fresh controller plan into the live policy (shared by
        the periodic control epoch and the degrade hook)."""
        gate = self.policy.gate
        if hasattr(gate, "update_targets"):
            gate.update_targets(plan.x, plan.qp)
        self.policy.plan = plan
        self.set_mixed_target(self.controller.mixed_target())

    # ------------------------------------------------------------ main loop
    def run(self, requests: Sequence[Request], horizon: float,
            failure_events: Sequence[tuple] = (),
            drain: bool = False) -> EngineMetrics:
        """Replay `requests` until `horizon`.

        ``failure_events``: iterable of
        (t, "fail"|"recover"|"straggle"|"degrade", sid[, speed/scale]).
        ``drain=False`` follows the paper's Section 6.2 convention (stop at the
        last prompt arrival); ``drain=True`` runs to `horizon`.
        """
        last_arrival = max(
            (r.t_arrival for r in requests if r.t_arrival <= horizon),
            default=horizon,
        )
        h_eff = horizon if drain else min(horizon, last_arrival)
        for r in requests:
            if r.t_arrival <= h_eff:
                self._push(r.t_arrival, "arrival", r)
        for ev in failure_events:
            self._push(ev[0], ev[1], ev[2:])
        if self.controller is not None:
            self._push(0.0, "control", None)
        next_qrec = 0.0
        tspec = resolve_probe_spec(getattr(self.cfg, "telemetry", None))
        if tspec is not None:
            self._probes = PyProbes(
                tspec, horizon=h_eff if h_eff > 0 else 1.0,
                n_servers=self.cfg.n_servers, n_classes=self.I)
        prev_ab = self.metrics.abandons

        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if t > h_eff:
                break
            self._now = t
            if kind == "arrival":
                r: Request = payload
                self.metrics.arrivals += 1
                self.metrics.per_class_arrivals[r.cls] = (
                    self.metrics.per_class_arrivals.get(r.cls, 0) + 1
                )
                job = _Job(r, prefill_left=r.prompt_len)
                self.prefill_q[r.cls].append(job)
                if self._probes is not None:
                    self._jobs.append(job)
                if self.controller is not None:
                    self.controller.observe_arrival(t, r.cls)
                self._admit_prefills()
            elif kind == "iter":
                self._finish_iteration(self.servers[payload])
            elif kind == "control":
                plan = self.controller.maybe_replan(t)
                if plan is not None:
                    self._publish_plan(plan)
                self._push(t + self.controller.cfg.replan_every, "control", None)
            elif kind == "fail":
                self.fail_server(payload[0])
            elif kind == "recover":
                self.recover_server(payload[0])
            elif kind == "straggle":
                self.set_straggler(payload[0], payload[1])
            elif kind == "degrade":
                self.set_link(payload[0], payload[1])
            if self._probes is not None:
                if self.metrics.abandons > prev_ab:
                    self._probes.count(
                        t, drops=self.metrics.abandons - prev_ab)
                    prev_ab = self.metrics.abandons
                self._probes.sample(
                    t,
                    queue_depth=[len(q) for q in self.prefill_q],
                    decode_occupancy=sum(
                        len(s.decodes) for s in self.servers),
                    prefill_in_flight=sum(
                        1 for s in self.servers if s.prefill is not None),
                    busy=[s.busy for s in self.servers])
            if (
                self.cfg.record_queues_every > 0
                and self._now >= next_qrec
            ):
                self.metrics.queue_trace.append(
                    (
                        self._now,
                        [len(q) for q in self.prefill_q],
                        len(self.decode_buf)
                        + len(self.decode_buf_solo)
                        + len(self.decode_buf_mixed),
                    )
                )
                next_qrec = self._now + self.cfg.record_queues_every

        self.metrics.horizon = h_eff
        if self._probes is not None:
            self.metrics.telemetry = self._probes.extract()
        return self.metrics

    def lifecycle_records(self, limit: Optional[int] = None) -> list:
        """Request-lifecycle records for the Chrome-trace exporter
        (:func:`repro_torch.telemetry.trace.lifecycle_events`).  This engine
        knows all three phase boundaries (admit, prefill-done, first
        emission), so the trace renders queue/prefill/decode spans."""
        if self._probes is None:
            raise ValueError("lifecycle records need a telemetry-enabled "
                             "run: set EngineConfig.telemetry")
        recs = []
        for job in (self._jobs if limit is None else self._jobs[:limit]):
            done = job.tokens_out >= job.req.decode_len
            recs.append({
                "rid": int(job.req.rid),
                "cls": self.classes[job.req.cls].name,
                "t_arr": float(job.req.t_arrival),
                "t_admit": float(job.t_admit),
                "t_prefill_done": float(job.t_prefill_done),
                "t_first": float(job.t_first_token),
                "t_last": float(job.t_last_token),
                "state": "done" if done else "active",
            })
        return recs
