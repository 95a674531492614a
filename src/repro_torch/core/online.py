"""Online adaptive controller (Section 6.2, Eqs. 50-51).

Estimates class-level arrival rates from a rolling window, periodically
re-solves the planning LP with a small regularising impatience parameter, and
publishes new targets (x*, q_p*, M*) to the running policy.  The controller is
engine-agnostic: the simulator/engine calls :meth:`observe_arrival` on every
arrival and :meth:`maybe_replan` at control epochs; elasticity (server
failures/joins) is handled by replanning with the current capacity ``n``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .planning import PlanSolution, SLISpec, solve_plan
from .types import Pricing, ServicePrimitives, WorkloadClass

__all__ = ["OnlineControllerConfig", "OnlineController",
           "replan_controllers_batch"]

SOLVERS = ("simplex", "lp_jax")


@dataclass(frozen=True)
class OnlineControllerConfig:
    window: float = 30.0  # W (seconds)
    safety: float = 3.0  # rho >= 1
    lam_min: float = 1e-6
    eps: float = 1e-9
    replan_every: float = 10.0
    planning_theta: float = 3e-4  # regularisation theta in the planning LP
    objective: str = "bundled"
    sli: Optional[SLISpec] = None
    # "simplex" = the exact serial oracle (repro_torch.core.lp); "lp_jax" =
    # the batched interior point (repro_torch.core.planning_batch)
    solver: str = "simplex"
    # where the "lp_jax" replans run: None is the card, "cpu" the host
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.solver not in SOLVERS:
            raise ValueError(
                f"solver {self.solver!r} not in {SOLVERS}")


class OnlineController:
    def __init__(
        self,
        classes: Sequence[WorkloadClass],
        prim: ServicePrimitives,
        pricing: Pricing,
        n: int,
        config: OnlineControllerConfig = OnlineControllerConfig(),
        on_replan: Optional[Callable[[PlanSolution, int], None]] = None,
    ):
        self.classes = tuple(classes)
        self.prim = prim
        self.pricing = pricing
        self.n = n
        self.cfg = config
        self.on_replan = on_replan
        self.I = len(self.classes)
        self._arrivals: list[list[float]] = [[] for _ in range(self.I)]
        self._next_replan = 0.0
        self.plan: Optional[PlanSolution] = None
        self.lam_hat = np.full(self.I, config.lam_min)
        self.replan_count = 0

    # -- observation hooks ---------------------------------------------------
    def observe_arrival(self, t: float, cls: int) -> None:
        self._arrivals[cls].append(t)

    def set_capacity(self, n: int, t: float) -> None:
        """Elastic capacity change (failure / join): replan immediately."""
        if n != self.n:
            self.n = n
            self.replan(t)

    # -- planning --------------------------------------------------------------
    def estimate_rates(self, t: float) -> np.ndarray:
        """Conservative rolling-window estimate, Eq. (50)."""
        cfg = self.cfg
        w_eff = min(cfg.window, max(t, cfg.eps))
        lo = t - cfg.window
        lam = np.empty(self.I)
        # a fully-failed cluster (n == 0, e.g. a capacity script killing
        # every server) still replans: normalize per surviving server,
        # or per single server while none survive
        denom = max(self.n, 1) * w_eff
        for i in range(self.I):
            ts = self._arrivals[i]
            # drop old events (amortised)
            k = 0
            while k < len(ts) and ts[k] < lo:
                k += 1
            if k:
                del ts[:k]
            lam[i] = max(cfg.safety * len(ts) / denom, cfg.lam_min)
        return lam

    def _planner_classes(self, t: float) -> tuple:
        self.lam_hat = self.estimate_rates(t)
        return tuple(
            dataclasses.replace(
                c, arrival_rate=float(self.lam_hat[i]),
                patience=self.cfg.planning_theta,
            )
            for i, c in enumerate(self.classes)
        )

    def _publish(self, plan: PlanSolution) -> PlanSolution:
        self.plan = plan
        self.replan_count += 1
        if self.on_replan is not None:
            self.on_replan(plan, plan.mixed_servers(self.n))
        return plan

    def replan(self, t: float) -> PlanSolution:
        classes = self._planner_classes(t)
        if self.cfg.solver == "lp_jax":
            from .planning_batch import solve_plan_jax

            plan = solve_plan_jax(classes, self.prim, self.pricing,
                                  objective=self.cfg.objective,
                                  sli=self.cfg.sli, device=self.cfg.device)
        else:
            plan = solve_plan(classes, self.prim, self.pricing,
                              objective=self.cfg.objective,
                              sli=self.cfg.sli)
        return self._publish(plan)

    def maybe_replan(self, t: float) -> Optional[PlanSolution]:
        if t >= self._next_replan:
            self._next_replan = t + self.cfg.replan_every
            return self.replan(t)
        return None

    def mixed_target(self) -> int:
        """Desired number of mixed servers M*(t_k), Eq. (51)."""
        if self.plan is None:
            return self.n
        return self.plan.mixed_servers(self.n)


def replan_controllers_batch(controllers: Sequence[OnlineController],
                             t: float) -> list:
    """Replan MANY controllers at one control epoch in a single batched
    interior-point solve (paired closed-loop sweeps: every scenario cell
    carries its own controller, and their epochs align by construction).

    All controllers must share objective/SLI config (one LP structure)
    and the config's ``device``; each contributes its own estimated rates,
    primitives, pricing and capacity.  Publishes each plan through the
    normal ``on_replan`` hook and returns the :class:`PlanSolution` list.
    """
    from .planning_batch import solve_plan_batch

    if not controllers:
        return []
    cfg0 = controllers[0].cfg
    for c in controllers:
        if (c.cfg.objective, c.cfg.sli, c.cfg.device) != (
                cfg0.objective, cfg0.sli, cfg0.device):
            raise ValueError(
                "replan_controllers_batch needs a homogeneous "
                "objective/sli/device across controllers (got "
                f"{(c.cfg.objective, c.cfg.sli, c.cfg.device)} vs "
                f"{(cfg0.objective, cfg0.sli, cfg0.device)})")
    instances = [c._planner_classes(t) for c in controllers]
    pb = solve_plan_batch(
        instances,
        prims=[c.prim for c in controllers],
        pricings=[c.pricing for c in controllers],
        objective=cfg0.objective,
        sli=cfg0.sli, device=cfg0.device).require_converged(
            "replan_controllers_batch")
    plans = []
    for k, c in enumerate(controllers):
        c._next_replan = max(c._next_replan, t + c.cfg.replan_every)
        plans.append(c._publish(pb.solution(k)))
    return plans
