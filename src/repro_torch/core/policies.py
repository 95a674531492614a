"""Scheduling policies: the paper's gate-and-route family and baselines.

A policy is a combination of

* a **prefill gate** -- which class to admit when a prefill slot idles
  (Section 4.1 occupancy rule; Section 5.1 priority rule; FCFS baseline),
* a **decode router** -- where completed prefills decode (Section 4.1
  solo-first; Section 5.2 randomized p_{s,i}; immediate/local baselines),
* **static planning** -- the mixed/solo partition M = ceil(n sum x_i*).

The same policy objects drive the aggregate CTMC simulator
(:mod:`repro_torch.core.simulator`) and the per-server iteration-level engine
(:mod:`repro_torch.serving.engine_sim`), so policy logic is written against the
minimal :class:`GateView` protocol below.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence

import numpy as np

from .planning import PlanSolution
from .types import WorkloadClass

__all__ = [
    "GateView",
    "PrefillGate",
    "OccupancyGate",
    "PriorityRatioGate",
    "FCFSGate",
    "DecodeRouterKind",
    "PolicySpec",
    "gate_and_route",
    "prioritize_and_route",
    "sli_aware_policy",
    "ablation_policy",
    "baseline_vllm",
    "baseline_sarathi",
    "baseline_distserve",
]


class GateView(Protocol):
    """What a prefill gate may observe (class-level state)."""

    def prefill_queue_len(self, i: int) -> int: ...
    def prefill_in_service(self, i: int) -> float: ...  # X_i
    def n_servers(self) -> int: ...
    def head_of_line_class(self) -> Optional[int]: ...  # oldest waiting job


class PrefillGate:
    def select(self, view: GateView, waiting: Sequence[int]) -> Optional[int]:
        raise NotImplementedError


class OccupancyGate(PrefillGate):
    """Paper Section 4.1: admit argmin_i xi_i = (X_i - n x_i*)/x_i*.

    Finite-n refinement: we evaluate the *post-admission* deviation
    xi_i = (X_i + 1 - n x_i*)/x_i* ("where would admitting one more leave
    this class?").  For classes with n*x_i* >= 1 this differs from the
    paper's rule by an O(1/x_i*) shift that vanishes relative to the
    O(sqrt(n))/x_i* fluctuations, so Theorem 2's asymptotics are untouched;
    for classes with tiny targets (n*x_i* < 1, short prefills) it prevents
    an integer-oscillation pathology where the class wins admission at
    every X_i = 0 epoch and gets over-admitted by ~P_code/P_i.

    Classes with x_i* == 0 are never admitted (their deviation is +inf);
    ties broken by largest queue deviation delta_i = Q_{p,i} - n q_{p,i}*.
    """

    def __init__(self, x_star: np.ndarray, qp_star: np.ndarray):
        self.x_star = np.asarray(x_star, dtype=float)
        self.qp_star = np.asarray(qp_star, dtype=float)

    def update_targets(self, x_star, qp_star) -> None:
        self.x_star = np.asarray(x_star, dtype=float)
        self.qp_star = np.asarray(qp_star, dtype=float)

    def select(self, view: GateView, waiting: Sequence[int]) -> Optional[int]:
        n = view.n_servers()
        best, best_key = None, None
        for i in waiting:
            if self.x_star[i] <= 1e-12:
                continue
            xi = (view.prefill_in_service(i) + 1.0
                  - n * self.x_star[i]) / self.x_star[i]
            delta = view.prefill_queue_len(i) - n * self.qp_star[i]
            key = (xi, -delta)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best


class PriorityRatioGate(PrefillGate):
    """Section 5.1: admit the waiting class with the largest D_i / P_i."""

    def __init__(self, classes: Sequence[WorkloadClass]):
        self.ratio = np.array([c.decode_len / c.prompt_len for c in classes])

    def select(self, view: GateView, waiting: Sequence[int]) -> Optional[int]:
        if not waiting:
            return None
        return max(waiting, key=lambda i: self.ratio[i])


class FCFSGate(PrefillGate):
    """Class-agnostic: admit the head-of-line job across all classes."""

    def select(self, view: GateView, waiting: Sequence[int]) -> Optional[int]:
        if not waiting:
            return None
        hol = view.head_of_line_class()
        return hol if hol is not None and hol in waiting else waiting[0]


DecodeRouterKind = str  # "solo_first" | "randomized" | "immediate" | "local_fcfs"


@dataclass
class PolicySpec:
    """Fully specifies a scheduling policy for either simulator.

    ``partition``: "static" (LP M), "none" (every server may prefill) or
    "fixed:<k>" (DistServe-style fixed split, k mixed/prefill servers).
    """

    name: str
    gate: PrefillGate
    router: DecodeRouterKind = "solo_first"
    partition: str = "static"
    plan: Optional[PlanSolution] = None
    # Randomized router targets (SLI-aware; Section 5.2 / EC.7):
    solo_prob: Optional[np.ndarray] = None  # p_{s,i}
    pool_weights_mixed: Optional[np.ndarray] = None  # varpi_{m,i}
    pool_weights_solo: Optional[np.ndarray] = None  # varpi_{s,i}
    # DistServe prefill/solo variant: prefill-only servers hand off all decodes.
    prefill_only_mixed: bool = False
    # Charging scheme used for revenue accounting ("bundled" | "separate").
    charging: str = "bundled"

    def mixed_target(self, n: int) -> int:
        if self.partition == "none":
            return n
        if self.partition.startswith("fixed:"):
            return min(n, int(self.partition.split(":")[1]))
        assert self.plan is not None, "static partition requires a plan"
        return self.plan.mixed_servers(n)

    def replace(self, **kw) -> "PolicySpec":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def gate_and_route(plan: PlanSolution, name: str = "gate_and_route") -> PolicySpec:
    """Occupancy-based Gate-and-Route with static planning (GG-SP, Section 4)."""
    return PolicySpec(
        name=name,
        gate=OccupancyGate(plan.x, plan.qp),
        router="solo_first",
        partition="static",
        plan=plan,
        charging="bundled",
    )


def prioritize_and_route(plan: PlanSolution,
                         name: str = "prioritize_and_route") -> PolicySpec:
    """Separate-charging Prioritize-and-Route (Section 5.1)."""
    return PolicySpec(
        name=name,
        gate=PriorityRatioGate(plan.classes),
        router="solo_first",
        partition="static",
        plan=plan,
        charging="separate",
    )


def sli_aware_policy(plan: PlanSolution, name: str = "sli_aware",
                     general: bool = False) -> PolicySpec:
    """SLI-aware Gate-and-Route (Section 5.2), randomized decode router.

    With ``general=True`` uses the EC.7 within-pool class-selection weights
    (supports plans with q_d* > 0).
    """
    arrm = plan.ym * np.array(
        [1.0 / (c.decode_len * plan.prim.tau_mix) for c in plan.classes]
    )
    arrs = plan.ys * np.array(
        [plan.prim.gamma / c.decode_len for c in plan.classes]
    )
    wm = arrm / arrm.sum() if arrm.sum() > 0 else np.ones_like(arrm) / len(arrm)
    ws = arrs / arrs.sum() if arrs.sum() > 0 else np.ones_like(arrs) / len(arrs)
    return PolicySpec(
        name=name,
        gate=OccupancyGate(plan.x, plan.qp),
        router="randomized",
        partition="static",
        plan=plan,
        solo_prob=plan.solo_probs(),
        pool_weights_mixed=wm if general else None,
        pool_weights_solo=ws if general else None,
        charging="bundled",
    )


def ablation_policy(plan: PlanSolution, which: str) -> PolicySpec:
    """EC.8.6 component ablations.

    GG-SP : full policy.           FI-WSP: FCFS gate, immediate decode, no SP.
    GI-WSP: gate, immediate, noSP. GF-WSP: gate, local FCFS router, no SP.
    FG-SP : FCFS gate, solo-first router, static planning.
    """
    table = {
        "GG-SP": dict(gate=OccupancyGate(plan.x, plan.qp), router="solo_first",
                      partition="static"),
        "FI-WSP": dict(gate=FCFSGate(), router="immediate", partition="none"),
        "GI-WSP": dict(gate=OccupancyGate(plan.x, plan.qp), router="immediate",
                       partition="none"),
        "GF-WSP": dict(gate=OccupancyGate(plan.x, plan.qp), router="local_fcfs",
                       partition="none"),
        "FG-SP": dict(gate=FCFSGate(), router="solo_first", partition="static"),
    }
    cfg = table[which]
    return PolicySpec(name=which, plan=plan, charging="bundled", **cfg)


def baseline_vllm(plan: PlanSolution) -> PolicySpec:
    """vLLM-style: prefill-first continuous batching, no split, class-agnostic."""
    return PolicySpec(
        name="vllm_style",
        gate=FCFSGate(),
        router="local_fcfs",
        partition="none",
        plan=plan,
        charging="bundled",
    )


def baseline_sarathi(plan: PlanSolution) -> PolicySpec:
    """Sarathi-style: admit when slots available, decode-first local execution."""
    return PolicySpec(
        name="sarathi_style",
        gate=FCFSGate(),
        router="immediate",
        partition="none",
        plan=plan,
        charging="bundled",
    )


def baseline_distserve(plan: PlanSolution, k: int,
                       variant: str = "mix_solo") -> PolicySpec:
    """DistServe-style best fixed split. ``variant``:

    * "mix_solo": k mixed servers (prefill+decode) vs n-k solo.
    * "prefill_solo": k prefill-only servers; all decodes go to solo group.
    """
    return PolicySpec(
        name=f"distserve_{variant}_k{k}",
        gate=FCFSGate(),
        router="solo_first",
        partition=f"fixed:{k}",
        plan=plan,
        prefill_only_mixed=(variant == "prefill_solo"),
        charging="bundled",
    )
