"""Closed-loop adaptive control on workload scenarios.

The reference's ``repro.workloads.closed_loop``, imports retargeted: it
wires :class:`repro_torch.core.online.OnlineController` into the
per-server :class:`repro_torch.serving.engine_sim.ClusterEngine` replay
of any registered
scenario -- the engine feeds every arrival to the controller, the
controller re-estimates class rates on a rolling window (Eq. 50),
re-solves the planning LP at control epochs, and publishes the new
occupancy/queue targets and mixed-server count M* (Eq. 51) back into the
running gate-and-route policy; scenario capacity events additionally
drive ``OnlineController.set_capacity`` replans through the engine's
failure hooks.

Variants (same trace, same engine seed -- paired comparisons):

* ``adaptive``    -- gate-and-route, cold-start plan, online replanning.
* ``static``      -- gate-and-route on the *hindsight* static plan
                     (full-trace empirical means; the strongest static
                     baseline).
* ``static_cold`` -- gate-and-route frozen on the cold-start plan (what
                     a no-controller deployment actually runs after a
                     regime shift).
* ``vllm`` / ``sarathi`` -- the class-agnostic system heuristics.

The cold-start plan is solved from the first ``cold_window`` seconds of
the trace, i.e. exactly the information a deployment has at launch; on
nonstationary scenarios (``rate_shift``, ``flash_crowd``, ``diurnal``)
the adaptive variant's win over the frozen plans is the paper's
Section 6.2 message.  The replays run on the host; the batched planner
of :func:`plans_for_scenarios` runs on the card unless ``device="cpu"``
is passed.  The reference's ``benchmarks/bench_scenarios.py`` tables
these comparisons over the whole registry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.online import OnlineController, OnlineControllerConfig
from repro_torch.core.planning import solve_bundled_lp
from repro_torch.core.policies import (baseline_sarathi, baseline_vllm,
                                 gate_and_route)
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass
from repro_torch.data.traces import trace_class_means, trace_class_means_windowed
from repro_torch.serving.engine_sim import ClusterEngine, EngineConfig

from .scenarios import Scenario, get_scenario

__all__ = ["ClosedLoopConfig", "VARIANTS", "run_closed_loop",
           "compare_policies", "plans_for_scenarios"]

VARIANTS = ("adaptive", "static", "static_cold", "vllm", "sarathi")


@dataclass(frozen=True)
class ClosedLoopConfig:
    """Knobs of one closed-loop scenario replay."""

    n_servers: int = 8
    horizon: Optional[float] = None  # None = the scenario's own horizon
    compression: float = 1.0
    rate_scale: float = 1.0
    seed: int = 0
    # controller (Section 6.2)
    replan_every: float = 10.0
    window: float = 30.0
    safety: float = 1.5
    planner_theta: float = 3e-4
    # planning inputs
    cold_window: float = 30.0  # launch-time knowledge for cold-start plans
    drain: bool = False

    def controller_config(self) -> OnlineControllerConfig:
        return OnlineControllerConfig(
            window=self.window, safety=self.safety,
            replan_every=self.replan_every,
            planning_theta=self.planner_theta)


def _classes_from_means(means, n: int, theta: float,
                        names: Sequence[str]) -> list:
    return [
        WorkloadClass(names[i] if i < len(names) else f"class{i}",
                      prompt_len=max(means[i][0], 1.0),
                      decode_len=max(means[i][1], 1.0),
                      arrival_rate=max(means[i][2] / n, 1e-6),
                      patience=theta)
        for i in range(len(means))
    ]


def _plan_classes(scn: Scenario, trace, cfg: ClosedLoopConfig):
    """(cold-start classes, hindsight classes) for one scenario replay."""
    I, names = scn.n_classes, scn.class_names
    n = cfg.n_servers
    windows = trace_class_means_windowed(trace, I, cfg.cold_window)
    cold_cls = _classes_from_means(windows[0][2], n, cfg.planner_theta, names)
    full_cls = _classes_from_means(trace_class_means(trace, I), n,
                                   cfg.planner_theta, names)
    return cold_cls, full_cls


def _plans(scn: Scenario, trace, cfg: ClosedLoopConfig, prim, pricing):
    """(cold classes, cold plan, hindsight classes, hindsight plan)."""
    cold_cls, full_cls = _plan_classes(scn, trace, cfg)
    return (cold_cls, solve_bundled_lp(cold_cls, prim, pricing),
            full_cls, solve_bundled_lp(full_cls, prim, pricing))


def plans_for_scenarios(scenarios: Sequence, traces: Sequence,
                        cfgs: Sequence[ClosedLoopConfig],
                        prim: Optional[ServicePrimitives] = None,
                        pricing: Optional[Pricing] = None, *,
                        device=None) -> list:
    """Cold-start + hindsight plans for MANY scenario replays in ONE
    batched interior-point solve on ``device`` (the card unless
    ``"cpu"``; :func:`repro_torch.core.planning_batch.solve_plan_batch`;
    class counts may differ across scenarios -- the batch pads
    internally).

    Returns one :func:`_plans`-shaped tuple per scenario, ready to pass
    to :func:`run_closed_loop` / :func:`compare_policies` via ``plans=``.
    ``bench_scenarios`` uses this to stop the registry-wide closed-loop
    table from serialising 2 x n_scenarios simplex solves.
    """
    prim = prim or ServicePrimitives()
    pricing = pricing or Pricing()
    scenarios = [get_scenario(s) if isinstance(s, str) else s
                 for s in scenarios]
    if not (len(scenarios) == len(traces) == len(cfgs)):
        raise ValueError("scenarios/traces/cfgs must align")
    pairs = [_plan_classes(scn, trace, cfg)
             for scn, trace, cfg in zip(scenarios, traces, cfgs)]
    from repro_torch.core.planning_batch import solve_plan_batch

    pb = solve_plan_batch(
        [cls for pair in pairs for cls in pair], prim, pricing,
        device=device).require_converged("plans_for_scenarios")
    return [
        (cold, pb.solution(2 * k), full, pb.solution(2 * k + 1))
        for k, (cold, full) in enumerate(pairs)
    ]


def run_closed_loop(scenario, variant: str = "adaptive",
                    cfg: ClosedLoopConfig = ClosedLoopConfig(),
                    prim: Optional[ServicePrimitives] = None,
                    pricing: Optional[Pricing] = None,
                    trace=None, plans=None, telemetry=None,
                    trace_path=None, manifest_path=None) -> dict:
    """Replay one scenario under one variant; returns a flat metric dict.

    ``scenario`` is a :class:`Scenario` or a registered name.  Pass a
    pre-generated ``trace`` to share it across variants (what
    :func:`compare_policies` does -- common random numbers); ``plans``
    (a :func:`_plans` tuple for that trace) additionally skips the
    per-variant LP re-solves, which depend only on trace + cfg.

    Observability riders (all default off; the metric dict is identical
    when they stay off):

    * ``telemetry`` -- a :class:`repro_torch.telemetry.ProbeSpec` / ``True`` /
      dict of overrides: threads time-binned probes through the engine
      and adds ``tlm_events`` / ``tlm_drops`` / ``tlm_ttft_p95`` to the
      returned metrics.
    * ``trace_path`` -- write a Chrome-trace JSON of request lifecycles
      plus replan/capacity instant events there (implies ``telemetry``).
    * ``manifest_path`` -- append one ``closed_loop`` RunRecord to this
      JSONL manifest (digesting the trace file when also written).
    """
    t_wall = time.time()
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if trace_path is not None and telemetry is None:
        telemetry = True  # lifecycle records need probes on
    prim = prim or ServicePrimitives()
    pricing = pricing or Pricing()
    n = cfg.n_servers
    if trace is None:
        trace = scenario.generate(seed=cfg.seed, horizon=cfg.horizon,
                                  compression=cfg.compression,
                                  rate_scale=cfg.rate_scale)
    horizon = float(cfg.horizon if cfg.horizon is not None
                    else scenario.horizon)
    cold_cls, cold_plan, full_cls, full_plan = (
        plans if plans is not None
        else _plans(scenario, trace, cfg, prim, pricing))

    controller = None
    if variant == "adaptive":
        classes, policy = cold_cls, gate_and_route(cold_plan)
        controller = OnlineController(cold_cls, prim, pricing, n=n,
                                      config=cfg.controller_config())
    elif variant == "static":
        classes, policy = full_cls, gate_and_route(full_plan)
    elif variant == "static_cold":
        classes, policy = cold_cls, gate_and_route(cold_plan)
    elif variant == "vllm":
        classes, policy = full_cls, baseline_vllm(full_plan)
    else:  # sarathi
        classes, policy = full_cls, baseline_sarathi(full_plan)

    replan_log: list = []
    if controller is not None and (trace_path is not None
                                   or manifest_path is not None):
        # the controller records a count but not epochs; intercept
        # replan(t) to keep the timeline for the trace export
        inner_replan = controller.replan

        def _logged_replan(t: float):
            plan = inner_replan(t)
            replan_log.append((float(t), {
                "epoch": len(replan_log) + 1, "n": controller.n,
                "mixed_target": int(plan.mixed_servers(controller.n))}))
            return plan

        controller.replan = _logged_replan

    ecfg = EngineConfig(prim, pricing, n, seed=cfg.seed,
                        sarathi_budget=(variant == "sarathi"),
                        telemetry=telemetry)
    eng = ClusterEngine(classes, policy, ecfg, controller=controller)
    m = eng.run(trace, horizon=horizon,
                failure_events=scenario.failure_events(n),
                drain=cfg.drain)
    out = m.summary()
    out["drops"] = float(m.abandons)  # expired/abandoned requests
    out["drop_rate"] = (m.abandons / m.arrivals) if m.arrivals else 0.0
    out["replans"] = float(controller.replan_count) if controller else 0.0
    out["mixed_target_final"] = float(
        controller.mixed_target() if controller
        else policy.mixed_target(n))
    if m.telemetry is not None:
        tl = m.telemetry
        out["tlm_events"] = float(tl["events"].sum())
        out["tlm_drops"] = float(tl["drops"].sum())
        out["tlm_ttft_p95"] = float(tl["ttft_p95"])
    artifacts = {}
    if trace_path is not None:
        from repro_torch.telemetry.trace import (lifecycle_events, replan_events,
                                           write_trace)

        events = lifecycle_events(eng.lifecycle_records())
        events += replan_events(replan_log)
        p = write_trace(trace_path, events,
                        source=f"closed_loop/{scenario.name}/{variant}")
        artifacts[str(p)] = None
    if manifest_path is not None:
        from repro_torch.telemetry.manifest import (append_record, file_digest,
                                              run_record)

        record = run_record(
            kind="closed_loop", name=f"{scenario.name}/{variant}",
            wall_s=time.time() - t_wall,
            extra={"n": n, "horizon": horizon, "seed": cfg.seed,
                   "n_requests": len(trace),
                   "replans": float(out["replans"]),
                   "telemetry": telemetry is not None},
            artifacts={p: file_digest(p) for p in artifacts})
        append_record(record, manifest_path)
    return {k: float(v) for k, v in out.items()}


def compare_policies(scenario, cfg: ClosedLoopConfig = ClosedLoopConfig(),
                     variants: Sequence[str] = ("adaptive", "static",
                                                "static_cold", "vllm"),
                     prim: Optional[ServicePrimitives] = None,
                     pricing: Optional[Pricing] = None,
                     trace=None, plans=None) -> dict:
    """All variants on ONE generated trace (paired by construction).

    Returns ``{"scenario", "n", "horizon", "n_requests", "variants":
    {name: metrics}, "adaptive_lead_pct": ...}`` where the lead is the
    adaptive variant's revenue-rate advantage over the hindsight static
    plan (positive = closed loop wins).  Pass ``trace`` / ``plans``
    (from :func:`plans_for_scenarios`) when comparing many scenarios:
    the plan solves then run as one batch instead of per call.
    """
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    prim = prim or ServicePrimitives()
    pricing = pricing or Pricing()
    if trace is None:
        trace = scenario.generate(seed=cfg.seed, horizon=cfg.horizon,
                                  compression=cfg.compression,
                                  rate_scale=cfg.rate_scale)
    if plans is None:
        plans = _plans(scenario, trace, cfg, prim, pricing)
    res = {
        v: run_closed_loop(scenario, v, cfg, prim=prim, pricing=pricing,
                           trace=trace, plans=plans)
        for v in variants
    }
    out = {
        "scenario": scenario.name,
        "n": cfg.n_servers,
        "horizon": float(cfg.horizon if cfg.horizon is not None
                         else scenario.horizon),
        "n_requests": len(trace),
        "variants": res,
    }
    if "adaptive" in res and "static" in res:
        base = res["static"]["revenue_rate"]
        out["adaptive_lead_pct"] = (
            100.0 * (res["adaptive"]["revenue_rate"] - base)
            / max(base, 1e-12))
    return out
