"""Cell evaluators + the policy-token registry for the sweep subsystem.

A *policy token* is a string naming a policy constructor, optionally with
``:key=value`` arguments, e.g.::

    "gate_and_route"              Section 4 occupancy gate + solo-first router
    "sli_aware"                   Section 5.2 randomized router (SLI plan)
    "GG-SP" ... "FG-SP"           EC.8.6 component ablations
    "vllm", "sarathi"             system baselines
    "distserve_mix_solo:k=4"      DistServe fixed split, absolute k
    "distserve_mix_solo:frac=0.2" fixed split, k = max(1, int(frac * n))

Tokens are resolved against a per-mix :class:`MixContext`, which caches the
planning-LP solves and (for the trace engine) the synthesized trace per
cluster size, so the embarrassingly-parallel seed axis never repeats
deterministic work.

Every evaluator here registers against the unified
:class:`~repro_torch.sweep.spec.Evaluator` protocol (one call signature,
``(ctx, token, n, *, seeds, **extra) -> metric dicts``) under its
:data:`~repro_torch.sweep.spec.EVALUATORS` name -- ``get_evaluator(name)``
is the one dispatch path the runner uses.  The names are the
reference's: ``ctmc_jax``, ``lp_jax``, ``fluid`` and ``engine_jax`` run
their batches on ``ctx.device`` (the card unless the caller passed
``"cpu"``), ``ctmc``, ``lp`` and ``engine`` on the host, bit for bit
with the reference.  The reference's deprecated ``evaluate_*`` shims are
not carried over: ``get_evaluator`` is the one entry.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.planning import (SLISpec, solve_bundled_lp,
                                       solve_separate_lp)
from repro_torch.core.policies import (PolicySpec, ablation_policy,
                                       baseline_distserve, baseline_sarathi,
                                       baseline_vllm, gate_and_route,
                                       prioritize_and_route,
                                       sli_aware_policy)
from repro_torch.core.simulator import CTMCSimulator
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass

from .spec import MixSpec, SweepSpec, cell_int_seed, register_evaluator

__all__ = [
    "ABLATION_TOKENS",
    "MixContext",
    "engine_policy_and_cfg",
    "evaluate_trace_policy",
    "parse_policy_token",
    "planner_classes_from_trace",
    "prewarm_plans",
    "resolve_policy",
]

# lp-family policy token -> MixContext.plan kind (shared by the serial
# "lp" evaluator and the batched "lp_jax" one)
LP_TOKEN_KINDS = {"lp": "base", "lp_bundled": "base",
                  "lp_separate": "separate", "lp_sli": "sli"}

# plan kind -> (objective, SLISpec) for the batched planner
PLAN_KINDS = {
    "base": ("bundled", None),
    "sli": ("bundled", SLISpec(pin_zero_decode_queue=True)),
    "separate": ("separate", None),
}

ABLATION_TOKENS = ("GG-SP", "FI-WSP", "GI-WSP", "GF-WSP", "FG-SP")


def parse_policy_token(token: str) -> tuple:
    """Split ``"name:k=v,k=v"`` into ``(name, {k: number})``."""
    name, _, argstr = token.partition(":")
    args = {}
    if argstr:
        for part in argstr.split(","):
            k, _, v = part.partition("=")
            if not v:
                raise ValueError(f"malformed policy token {token!r}")
            args[k.strip()] = float(v)
    return name.strip(), args


class MixContext:
    """Per-mix caches shared across the policy/n/seed axes of one sweep.

    ``device`` is where the batched evaluators and the batched planner
    run (resolved: the card unless ``"cpu"`` is passed)."""

    def __init__(self, mix: MixSpec, spec: SweepSpec, device=None):
        self.mix = mix
        self.spec = spec
        self.device = resolve_device(device)
        self.classes = mix.workload_classes()
        self.prim = mix.primitives()
        self.pricing = mix.price()
        self._plans: dict = {}
        self._traces: dict = {}
        self._trace_classes: dict = {}
        # whole-grid Evaluator.prepare hooks park per-token metrics here
        # (keys like ("fluid", token) / ("lp_jax", token))
        self.cache: dict = {}

    # -- planning --------------------------------------------------------------
    def plan(self, kind: str = "base"):
        """LP solutions, cached: "base" (bundled), "sli" (pinned q_d = 0,
        the Section 5.2 router's standing assumption), "separate"."""
        if kind not in self._plans:
            if kind == "base":
                p = solve_bundled_lp(self.classes, self.prim, self.pricing)
            elif kind == "sli":
                p = solve_bundled_lp(
                    self.classes, self.prim, self.pricing,
                    sli=SLISpec(pin_zero_decode_queue=True))
            elif kind == "separate":
                p = solve_separate_lp(self.classes, self.prim, self.pricing)
            else:
                raise ValueError(kind)
            self._plans[kind] = p
        return self._plans[kind]

    # -- trace engine ----------------------------------------------------------
    def trace(self, n: int):
        """Synthesized trace for cluster size n (cached across policies/seeds).

        ``compression_per_server`` in the mix's trace overrides resolves to
        ``compression = value / n`` so per-server offered load stays fixed
        while the cluster grows (the EC.8.3 protocol).  A mix with a
        ``scenario`` name generates from the workload-scenario registry
        (:func:`repro_torch.workloads.get_scenario`) instead of the raw
        ``TraceConfig``; the same overrides apply (narrowed to
        :meth:`Scenario.generate`'s knobs)."""
        if n not in self._traces:
            kw = dict(self.mix.trace)
            cps = kw.pop("compression_per_server", None)
            if cps is not None:
                kw["compression"] = float(cps) / n
            if self.mix.scenario:
                from repro_torch.workloads import get_scenario

                allowed = {"seed", "horizon", "compression", "rate_scale"}
                bad = set(kw) - allowed
                if bad:
                    raise ValueError(
                        f"mix {self.mix.name!r}: trace overrides {sorted(bad)} "
                        f"not supported with scenario={self.mix.scenario!r} "
                        f"(allowed: {sorted(allowed)})")
                self._traces[n] = get_scenario(self.mix.scenario).generate(**kw)
            else:
                from repro_torch.data.traces import TraceConfig, synth_azure_trace

                self._traces[n] = synth_azure_trace(TraceConfig(**kw))
        return self._traces[n]

    def trace_classes(self, n: int):
        if n not in self._trace_classes:
            self._trace_classes[n] = planner_classes_from_trace(
                self.trace(n), n,
                theta=float(self.spec.extra.get("planner_theta", 3e-4)))
        return self._trace_classes[n]

    def trace_plan(self, n: int):
        """Planning LP over the trace-derived classes, cached per n so the
        policy and seed axes never repeat the (deterministic) solve."""
        key = ("trace_plan", n)
        if key not in self._plans:
            self._plans[key] = solve_bundled_lp(
                self.trace_classes(n), self.prim, self.pricing)
        return self._plans[key]


def planner_classes_from_trace(trace, n: int, n_classes: Optional[int] = None,
                               theta: float = 3e-4):
    """Planner inputs from a trace's empirical per-class means."""
    from repro_torch.data.traces import trace_class_means

    if n_classes is None:
        n_classes = max(r.cls for r in trace) + 1
    means = trace_class_means(trace, n_classes)
    return [
        WorkloadClass(f"class{i}", prompt_len=means[i][0],
                      decode_len=means[i][1],
                      arrival_rate=max(means[i][2] / n, 1e-6),
                      patience=theta)
        for i in range(n_classes)
    ]


def resolve_policy(token: str, ctx: MixContext, n: int) -> PolicySpec:
    """Instantiate a policy token for cluster size ``n``."""
    name, args = parse_policy_token(token)
    if name == "gate_and_route":
        return gate_and_route(ctx.plan("base"))
    if name == "gate_and_route_separate":
        # the same plan-tracking occupancy gate, instantiated from the
        # Eq. (42) separate-charging plan and charged separately -- the
        # Theorem 2/3 policy family under the other pricing scheme
        # (bench_optimality_gap's separate-scheme policy)
        return gate_and_route(
            ctx.plan("separate"),
            name="gate_and_route_separate").replace(charging="separate")
    if name == "prioritize_and_route":
        return prioritize_and_route(ctx.plan("separate"))
    if name == "sli_aware":
        return sli_aware_policy(ctx.plan("sli"))
    if name == "sli_aware_general":
        return sli_aware_policy(ctx.plan("sli"), general=True)
    if name in ABLATION_TOKENS:
        return ablation_policy(ctx.plan("base"), name)
    if name == "vllm":
        return baseline_vllm(ctx.plan("base"))
    if name == "sarathi":
        return baseline_sarathi(ctx.plan("base"))
    if name in ("distserve_mix_solo", "distserve_prefill_solo"):
        variant = name[len("distserve_"):]
        k = _distserve_k(args, n)
        return baseline_distserve(ctx.plan("base"), k, variant=variant)
    raise ValueError(f"unknown policy token {token!r}")


def _distserve_k(args: dict, n: int) -> int:
    if "k" in args:
        return int(args["k"])
    if "frac" in args:
        return max(1, int(args["frac"] * n))
    raise ValueError("distserve token needs k= or frac=")


# ---------------------------------------------------------------------------
# CTMC evaluator (aggregate exact simulation; Section 2.3 / EC.8.5)
# ---------------------------------------------------------------------------


def _ctmc_metrics(res, plan) -> dict:
    m = {
        "revenue_rate": float(res.revenue_rate_per_server),
        "R_star": float(plan.revenue_rate),
        "completions": float(res.completions.sum()),
        "arrivals": float(res.arrivals.sum()),
        "abandons_p": float(res.abandons_p.sum()),
        "abandons_d": float(res.abandons_d.sum()),
    }
    if plan.revenue_rate > 0:
        m["gap_pct"] = 100.0 * (1.0 - m["revenue_rate"] / m["R_star"])
    avg_y = res.avg_ym + res.avg_ys
    y_star = plan.ym + plan.ys
    for i in range(len(plan.x)):
        m[f"avg_x/{i}"] = float(res.avg_x[i])
        m[f"avg_y/{i}"] = float(avg_y[i])
        m[f"avg_qp/{i}"] = float(res.avg_qp[i])
        m[f"avg_qd/{i}"] = float(res.avg_qd[i])
        m[f"x_star/{i}"] = float(plan.x[i])
        m[f"y_star/{i}"] = float(y_star[i])
    m["x_err_l1"] = float(np.abs(res.avg_x - plan.x).sum())
    m["y_err_l1"] = float(np.abs(avg_y - y_star).sum())
    return m


@register_evaluator("ctmc")
def _eval_ctmc(ctx: MixContext, token: str, n: int, *,
               seeds: Sequence[np.random.SeedSequence]) -> list:
    """All seed replications of one (mix, policy, n) cell.

    One simulator instance serves the whole replication batch
    (:meth:`CTMCSimulator.run_batch`); each replication gets its own
    spawned stream, so any single cell is exactly reproducible by a direct
    ``CTMCSimulator(..., seed=cell_seed_sequence(...)).run(...)`` call.
    """
    policy = resolve_policy(token, ctx, n)
    spec = ctx.spec
    sim = CTMCSimulator(ctx.classes, ctx.prim, ctx.pricing, policy, n=n,
                        seed=seeds[0], record_every=spec.record_every,
                        telemetry=spec.extra.get("telemetry"))
    results = sim.run_batch(spec.horizon, warmup=spec.warmup, rngs=seeds)
    # judge each policy against its own planning targets (the SLI-aware
    # router plans with q_d pinned to zero, so its x*/y*/R* differ)
    plan = policy.plan if policy.plan is not None else ctx.plan("base")
    out = []
    for r in results:
        m = _ctmc_metrics(r, plan)
        if r.telemetry is not None:
            m["tlm_events"] = float(r.telemetry["events"].sum())
            m["tlm_drops"] = float(r.telemetry["drops"].sum())
        out.append(m)
    return out


# ---------------------------------------------------------------------------
# Uniformized CTMC evaluator (same law, the seed axis as one batch)
# ---------------------------------------------------------------------------


@register_evaluator("ctmc_jax")
def _eval_ctmc_jax(ctx: MixContext, token: str, n: int, *,
                   seeds: Sequence[np.random.SeedSequence],
                   placement: Optional[str] = None,
                   shard: Optional[dict] = None) -> list:
    """All seed replications of one (mix, policy, n) cell, as ONE
    batched run of the uniformized CTMC engine
    (:class:`repro_torch.core.ctmc_jax.UniformizedCTMC`, whose event loop
    is the ``ctmc_scan`` kernel on the card) on ``ctx.device``.

    Emits the same metric keys as the Python ``ctmc`` evaluator plus
    three engine diagnostics: ``t_end`` (must equal the horizon --
    smaller means the fixed step budget ran out), ``clip_steps``
    (ticks-mode abandonment-cap clip count; 0 in the default events
    mode) and ``n_events`` (real transitions simulated).  ``stepping``,
    ``n_steps`` and ``x64`` can be overridden via
    ``spec.extra["ctmc_jax"]``.

    ``x64=True`` runs the whole cell in float64 (the reference's
    ``enable_x64`` scope): required at production cluster sizes, where
    the mean inter-event time ``1/(3 n lam)`` drops below the ULP of a
    float32 clock and the clock stalls mid-horizon (``t_end < horizon``).

    ``placement`` picks the batch execution strategy (one of
    :data:`repro_torch.sweep.sharded.PLACEMENTS`; default
    ``spec.extra["placement"]`` or ``"vmap"``) and ``shard`` passes
    ``devices`` and tiling overrides to
    :func:`repro_torch.sweep.sharded.run_sharded`; metric values are
    bitwise identical across placements.
    """
    from repro_torch.core.ctmc_jax import UniformizedCTMC

    spec = ctx.spec
    if placement is None:
        placement = spec.extra.get("placement", "vmap")
    if shard is None:
        shard = spec.extra.get("shard")
    if spec.record_every > 0:
        raise ValueError("the ctmc_jax evaluator does not record "
                         "trajectories; use evaluator='ctmc'")
    kw = dict(spec.extra.get("ctmc_jax", {}))
    dtype = torch.float64 if bool(kw.pop("x64", False)) else torch.float32
    kw.setdefault("telemetry", spec.extra.get("telemetry"))
    policy = resolve_policy(token, ctx, n)
    sim = UniformizedCTMC(ctx.classes, ctx.prim, ctx.pricing, policy,
                          n=n, horizon=spec.horizon, warmup=spec.warmup,
                          dtype=dtype, device=ctx.device, **kw)
    raw = sim.run_batch_raw([cell_int_seed(ss) for ss in seeds],
                            placement=placement, shard=shard)
    results = sim.results_from_raw(raw)
    host = {k: v.cpu().numpy() for k, v in raw.items()
            if k in ("clip_steps", "tlm_ev", "tlm_drop")}
    plan = policy.plan if policy.plan is not None else ctx.plan("base")
    out = []
    for r, res in enumerate(results):
        m = _ctmc_metrics(res, plan)
        m["t_end"] = float(res.t_end)
        m["clip_steps"] = float(host["clip_steps"][r])
        m["n_events"] = float(res.n_events)
        if sim.telemetry is not None:
            m["tlm_events"] = float(host["tlm_ev"][r].sum())
            m["tlm_drops"] = float(host["tlm_drop"][r].sum())
        out.append(m)
    return out


# ---------------------------------------------------------------------------
# Planning-LP evaluator (deterministic; Figs. 7-8 style sweeps)
# ---------------------------------------------------------------------------


@register_evaluator("lp", deterministic=True)
def _eval_lp(ctx: MixContext, token: str, n: int, *, seeds=()) -> dict:
    """Optimal-plan metrics for one mix (policy axis picks the objective).

    Deterministic: returns ONE metrics dict; the :class:`Evaluator`
    protocol replicates it over the degenerate seed axis.
    """
    name, _ = parse_policy_token(token)
    kind = LP_TOKEN_KINDS.get(name)
    if kind is None:
        raise ValueError(f"lp evaluator got non-lp policy token {token!r}")
    return _lp_metrics(ctx.plan(kind))


def _lp_metrics(plan) -> dict:
    from repro_torch.core.planning import tpot_of_plan

    m = {
        "revenue": float(plan.revenue_rate),
        "tpot": float(tpot_of_plan(plan)),
        "x_total": float(plan.x_total),
    }
    for i in range(len(plan.x)):
        m[f"x_star/{i}"] = float(plan.x[i])
        m[f"y_star/{i}"] = float(plan.ym[i] + plan.ys[i])
        m[f"qp_star/{i}"] = float(plan.qp[i])
    return m


# ---------------------------------------------------------------------------
# Batched planning-LP evaluator (batched interior point on the device;
# same grid semantics as "lp", whole (mix x policy) plane per plan kind)
# ---------------------------------------------------------------------------


def _lp_jax_grid(contexts: Sequence[MixContext],
                 policies: Sequence[str],
                 extra: Optional[dict] = None) -> dict:
    """Metrics for every (mix, lp-policy) pair via
    :func:`repro_torch.core.planning_batch.solve_plan_batch` -- one
    batched float64 interior-point run per plan kind on the contexts'
    device instead of a Python loop of simplex solves.

    Returns ``{(mix_index, policy_index): metrics}``; the runner
    replicates cells over the degenerate (n, seed) axes exactly as for
    the ``lp`` and ``fluid`` evaluators.  Cells carry the ``lp``
    evaluator's keys plus solver diagnostics: ``lp_primal_res`` /
    ``lp_dual_res`` / ``lp_gap`` (final relative residuals),
    ``lp_converged`` (1.0 iff all three beat the tolerance) and
    ``lp_iters`` (Newton steps taken).  ``extra["lp_jax"]`` may override
    ``{"iters": ..., "tol": ...}``.
    """
    from repro_torch.core.planning_batch import solve_plan_batch

    kw = dict((extra or {}).get("lp_jax", {}))
    jobs: dict = {}  # plan kind -> list of (mi, pi)
    for pi, token in enumerate(policies):
        name, _ = parse_policy_token(token)
        kind = LP_TOKEN_KINDS.get(name)
        if kind is None:
            raise ValueError(
                f"lp_jax evaluator got non-lp policy token {token!r}")
        for mi in range(len(contexts)):
            jobs.setdefault(kind, []).append((mi, pi))

    out: dict = {}
    for kind, cells in jobs.items():
        objective, sli = PLAN_KINDS[kind]
        pb = solve_plan_batch(
            [contexts[mi].classes for mi, _ in cells],
            prims=[contexts[mi].prim for mi, _ in cells],
            pricings=[contexts[mi].pricing for mi, _ in cells],
            objective=objective, sli=sli, device=contexts[0].device, **kw)
        for b, (mi, pi) in enumerate(cells):
            m = _lp_metrics(pb.solution(b))
            m["lp_primal_res"] = float(pb.primal_res[b])
            m["lp_dual_res"] = float(pb.dual_res[b])
            m["lp_gap"] = float(pb.gap[b])
            m["lp_converged"] = float(bool(pb.converged[b]))
            m["lp_iters"] = float(pb.n_iter[b])
            out[(mi, pi)] = m
    return out


def _lp_jax_prepare(contexts: Sequence[MixContext],
                    policies: Sequence[str],
                    extra: Optional[dict] = None) -> None:
    """Whole-grid hook: one batched interior-point run per plan kind,
    metrics parked in each ``ctx.cache[("lp_jax", token)]``."""
    grid = _lp_jax_grid(contexts, policies, extra)
    for (mi, pi), m in grid.items():
        contexts[mi].cache[("lp_jax", policies[pi])] = m


@register_evaluator("lp_jax", deterministic=True, prepare=_lp_jax_prepare)
def _eval_lp_jax(ctx: MixContext, token: str, n: int, *, seeds=()) -> dict:
    """Batched-planner metrics for one cell, served from the
    ``prepare`` cache (the runner batch-solves the whole (mix x policy)
    plane up front); a cache miss falls back to a solo batch of one."""
    key = ("lp_jax", token)
    if key not in ctx.cache:
        _lp_jax_prepare([ctx], [token], ctx.spec.extra)
    return ctx.cache[key]


# ---------------------------------------------------------------------------
# Fluid-limit evaluator (deterministic; one batched integration per grid)
# ---------------------------------------------------------------------------


def _fluid_prepare(contexts: Sequence[MixContext],
                   policies: Sequence[str],
                   extra: Optional[dict] = None) -> None:
    """Whole-grid hook: integrate the full (mix x policy) plane as ONE
    batched Euler loop per router family on the contexts' device
    (:func:`repro_torch.sweep.fluid_batch.evaluate_fluid_grid`), metrics
    parked in each ``ctx.cache[("fluid", token)]``."""
    from .fluid_batch import evaluate_fluid_grid

    dt = float((extra or {}).get("dt", 2e-3))
    grid = evaluate_fluid_grid(contexts, policies,
                               contexts[0].spec.horizon, dt)
    for (mi, pi), m in grid.items():
        contexts[mi].cache[("fluid", policies[pi])] = m


@register_evaluator("fluid", deterministic=True, prepare=_fluid_prepare)
def _eval_fluid(ctx: MixContext, token: str, n: int, *, seeds=()) -> dict:
    """Fluid-limit metrics for one cell, served from the ``prepare``
    cache; a cache miss falls back to a solo integration.  The fluid
    limit has no cluster-size or seed dependence, so one dict covers the
    degenerate (n, seed) axes."""
    key = ("fluid", token)
    if key not in ctx.cache:
        _fluid_prepare([ctx], [token], ctx.spec.extra)
    return ctx.cache[key]


def prewarm_plans(contexts: Sequence[MixContext],
                  tokens: Sequence[str]) -> int:
    """Batch-solve the class-derived planning LPs the given policy tokens
    will need and stuff every :class:`MixContext` plan cache, so the
    per-cell ``ctx.plan(...)`` lookups never fall back to the serial
    simplex (``spec.extra["batch_plans"]`` turns this on in the runner).

    Returns the number of (mix, kind) plans solved.  Trace-derived plans
    (``MixContext.trace_plan``) are per-``n`` and stay on the oracle
    path.
    """
    from repro_torch.core.planning_batch import solve_plan_batch

    kinds = set()
    for token in tokens:
        name, _ = parse_policy_token(token)
        if name in LP_TOKEN_KINDS:
            kinds.add(LP_TOKEN_KINDS[name])
        elif name in ("sli_aware", "sli_aware_general"):
            kinds.add("sli")
        elif name in ("prioritize_and_route", "gate_and_route_separate"):
            kinds.add("separate")
        else:  # gate_and_route / ablations / system baselines
            kinds.add("base")
    todo = [(ctx, kind) for kind in sorted(kinds) for ctx in contexts
            if ctx.mix.classes and kind not in ctx._plans]
    for kind in sorted({k for _, k in todo}):
        group = [ctx for ctx, k in todo if k == kind]
        objective, sli = PLAN_KINDS[kind]
        pb = solve_plan_batch(
            [ctx.classes for ctx in group],
            prims=[ctx.prim for ctx in group],
            pricings=[ctx.pricing for ctx in group],
            objective=objective, sli=sli,
            device=group[0].device).require_converged(
                f"prewarm_plans[{kind}]")
        for b, ctx in enumerate(group):
            ctx._plans[kind] = pb.solution(b)
    return len(todo)


# ---------------------------------------------------------------------------
# Per-server trace engine evaluators (Section 6.2 calibrated simulator)
# ---------------------------------------------------------------------------


def engine_policy_and_cfg(token: str, plan, prim: ServicePrimitives,
                          pricing: Pricing, n: int, seed: int = 0):
    """Resolve a trace-engine policy token to ``(PolicySpec, EngineConfig)``.

    Shared by the Python ``engine`` evaluator and the batched
    ``engine_jax`` one, so both understand exactly the same token set:
    ``gate_and_route``, ``sarathi`` (decode-first chunk budget), ``vllm``
    (prefill-first; chunking stays a system property C, exactly as in the
    paper's Section 2 model) and the two DistServe fixed splits.
    """
    from repro_torch.serving.engine_sim import EngineConfig

    name, args = parse_policy_token(token)
    cfg = EngineConfig(prim, pricing, n, seed=seed)
    if name == "gate_and_route":
        policy = gate_and_route(plan)
    elif name == "sarathi":
        policy = baseline_sarathi(plan)
        cfg = EngineConfig(prim, pricing, n, seed=seed, sarathi_budget=True)
    elif name == "vllm":
        policy = baseline_vllm(plan)
    elif name in ("distserve_mix_solo", "distserve_prefill_solo"):
        policy = baseline_distserve(plan, _distserve_k(args, n),
                                    variant=name[len("distserve_"):])
    else:
        raise ValueError(f"engine evaluator got unknown policy {token!r}")
    return policy, cfg


def evaluate_trace_policy(token: str, trace, n: int, *,
                          prim: Optional[ServicePrimitives] = None,
                          pricing: Optional[Pricing] = None,
                          horizon: float = 600.0, online: bool = True,
                          seed: int = 42, sli: Optional[SLISpec] = None,
                          safety: float = 3.0,
                          classes=None, plan=None, telemetry=None) -> dict:
    """One (policy, trace) evaluation in the calibrated per-server engine.

    This is the single implementation behind the sweep's "engine"
    evaluator (the reference's ``benchmarks.common.run_trace_policy``
    calls its twin).  Pass a
    pre-solved ``plan`` (with matching ``classes``) to skip the LP solve;
    the sweep runner does this via :meth:`MixContext.trace_plan`.
    """
    from repro_torch.core.online import (OnlineController,
                                         OnlineControllerConfig)
    from repro_torch.serving.engine_sim import ClusterEngine

    prim = prim or ServicePrimitives()
    pricing = pricing or Pricing()
    if classes is None:
        classes = planner_classes_from_trace(trace, n)
    if plan is None:
        plan = solve_bundled_lp(classes, prim, pricing, sli=sli)
    name, args = parse_policy_token(token)
    policy, cfg = engine_policy_and_cfg(token, plan, prim, pricing, n,
                                        seed=seed)
    if telemetry is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, telemetry=telemetry)
    controller = None
    if name == "gate_and_route" and online:
        controller = OnlineController(
            classes, prim, pricing, n=n,
            config=OnlineControllerConfig(sli=sli, safety=safety))
    eng = ClusterEngine(classes, policy, cfg, controller=controller)
    m = eng.run(trace, horizon=horizon)
    out = m.summary()
    if name.startswith("distserve_"):
        out["distserve_k"] = _distserve_k(args, n)
    if m.telemetry is not None:
        out["tlm_events"] = float(m.telemetry["events"].sum())
        out["tlm_drops"] = float(m.telemetry["drops"].sum())
        out["tlm_ttft_p95"] = float(m.telemetry["ttft_p95"])
    return {k: float(v) for k, v in out.items()}


def _engine_cell(ctx: MixContext, token: str, n: int,
                 ss: np.random.SeedSequence) -> dict:
    spec = ctx.spec
    return evaluate_trace_policy(
        token, ctx.trace(n), n,
        prim=ctx.prim, pricing=ctx.pricing,
        horizon=spec.horizon,
        online=bool(spec.extra.get("online", True)),
        seed=cell_int_seed(ss),
        safety=float(spec.extra.get("safety", 3.0)),
        classes=ctx.trace_classes(n),
        plan=ctx.trace_plan(n),
        telemetry=spec.extra.get("telemetry"),
    )


@register_evaluator("engine")
def _eval_engine(ctx: MixContext, token: str, n: int, *,
                 seeds: Sequence[np.random.SeedSequence]) -> list:
    """Per-seed replications of the Python trace engine (serial loop of
    :func:`evaluate_trace_policy`; trace / planner-classes / plan cached
    per n on the context)."""
    return [_engine_cell(ctx, token, n, ss) for ss in seeds]


@register_evaluator("engine_jax")
def _eval_engine_jax(ctx: MixContext, token: str, n: int, *,
                     seeds: Sequence[np.random.SeedSequence],
                     placement: Optional[str] = None,
                     shard: Optional[dict] = None) -> list:
    """All seed replications of one (mix, policy, n) cell, as ONE
    batched run of the iteration-level trace-replay engine
    (:class:`repro_torch.serving.engine_jax.ClusterEngineJAX`, its step
    in CUDA graphs on the card) on ``ctx.device``.

    Same policy tokens and summary-metric keys as the Python ``engine``
    evaluator, plus four engine diagnostics: ``t_end`` (last processed
    event time), ``budget_exhausted`` (1.0 iff the fixed scan budget cut
    the replay short -- asserted 0 by the CI smoke), ``n_iters`` /
    ``n_events`` (iterations / events simulated) and ``n_dropped``
    (requests cut by a ``max_requests`` cap).  Differences from the
    Python evaluator: the online controller is not supported, so
    ``gate_and_route`` runs open-loop on the static plan, and engine
    kwargs (``max_steps``, ``max_requests``, ``drain``, plus the hot-path
    switches ``fastforward`` and ``k_events`` -- see the engine module
    docstring for when each applies) come from
    ``spec.extra["engine_jax"]``.

    ``placement`` / ``shard`` select the batch execution strategy
    exactly as for the ``ctmc_jax`` evaluator (defaults from
    ``spec.extra``); metric values are bitwise identical across
    placements.
    """
    from repro_torch.serving.engine_jax import ClusterEngineJAX

    spec = ctx.spec
    if placement is None:
        placement = spec.extra.get("placement", "vmap")
    if shard is None:
        shard = spec.extra.get("shard")
    if spec.record_every > 0:
        raise ValueError("the engine_jax evaluator does not record "
                         "queue traces; use evaluator='engine'")
    kw = dict(spec.extra.get("engine_jax", {}))
    if spec.extra.get("telemetry") is not None:
        kw.setdefault("telemetry", spec.extra["telemetry"])
    policy, cfg = engine_policy_and_cfg(token, ctx.trace_plan(n), ctx.prim,
                                        ctx.pricing, n)
    eng = ClusterEngineJAX(ctx.trace_classes(n), policy, cfg, ctx.trace(n),
                           horizon=spec.horizon, device=ctx.device, **kw)
    raw = eng.run_batch_raw([cell_int_seed(ss) for ss in seeds],
                            placement=placement, shard=shard)
    out = eng.summaries_from_raw(raw)
    name, args = parse_policy_token(token)
    if name.startswith("distserve_"):
        for m in out:
            m["distserve_k"] = _distserve_k(args, n)
    if eng.telemetry is not None:
        from repro_torch.telemetry.probes import hist_edges, hist_percentile

        edges = hist_edges(eng.telemetry)
        ev = raw["tlm_ev"].cpu().numpy()
        dr = raw["tlm_drop"].cpu().numpy()
        tt = raw["tlm_ttft"].cpu().numpy()
        for r, m in enumerate(out):
            m["tlm_events"] = float(ev[r].sum())
            m["tlm_drops"] = float(dr[r].sum())
            m["tlm_ttft_p95"] = float(hist_percentile(tt[r], edges, 95))
    return [{k: float(v) for k, v in m.items()} for m in out]
