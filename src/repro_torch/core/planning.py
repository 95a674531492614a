"""Steady-state fluid planning LPs (paper Eqs. 40, 42, 49).

Variables per class i (block layout, I classes):

    x[i]    prefill occupancy per server            (fraction of a server)
    ym[i]   mixed-mode decode occupancy per server  (slots)
    ys[i]   solo-mode decode occupancy per server   (slots)
    qp[i]   prefill queue mass per server
    qd[i]   decode queue mass per server

Constraints (LP 40):

    sum_i x[i]                 <= 1
    sum_i ym[i] - (B-1) sum x  <= 0
    sum_i ys[i] + B sum x      <= B
    mu_p[i] x[i] + theta[i] qp[i]                        == lam[i]     (prefill FB)
    mu_p[i] x[i] - theta[i] qd[i] - mu_m[i] ym[i] - mu_s[i] ys[i] == 0 (decode FB)

SLI extensions (Section 5): prefill/decode fairness (pairwise linearised max
gap), TPOT cap (47) which is linear after cross-multiplying, optional
``q_d = 0`` pinning, and penalty (soft) forms via auxiliary gap variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .lp import LPResult, linprog_max
from .types import (Pricing, ServicePrimitives, WorkloadClass, rate_arrays,
                    resolve_primitives)

__all__ = [
    "PlanSolution",
    "SLISpec",
    "solve_bundled_lp",
    "solve_separate_lp",
    "solve_plan",
    "tpot_of_plan",
    "validate_planning_instance",
]


def validate_planning_instance(classes, capacity: float = 1.0,
                               label: str = "planning LP") -> tuple:
    """Reject degenerate planner inputs with a diagnostic LPInfeasible.

    The simplex/IPM layers assume a nonempty class list with *some*
    offered traffic and positive service capacity; violating that used
    to surface as an IndexError deep in the tableau (empty classes) or a
    silently meaningless all-zero plan (no traffic).  Shared by
    :func:`solve_plan` and :func:`repro_torch.core.planning_batch.solve_plan_batch`.
    """
    from .lp import LPInfeasible

    classes = tuple(classes)
    if not classes:
        raise LPInfeasible(
            f"{label}: empty class list -- the steady-state plan needs at "
            "least one workload class")
    lam = np.array([c.arrival_rate for c in classes], dtype=np.float64)
    if not np.any(lam > 0):
        names = [c.name for c in classes]
        raise LPInfeasible(
            f"{label}: degenerate instance -- all arrival rates are zero "
            f"(classes={names}); the plan is undefined without traffic "
            "(feed estimated rates, e.g. OnlineController.estimate_rates, "
            "which floors at lam_min)")
    if not capacity > 0:
        raise LPInfeasible(
            f"{label}: zero service capacity (capacity={capacity:g}) "
            f"cannot serve offered load lam_total={float(lam.sum()):.4g}")
    return classes


@dataclass(frozen=True)
class SLISpec:
    """Service-level-indicator configuration for the planning LP (Section 5).

    ``None`` disables a term.  Hard caps are constraints (43)/(45)/(47);
    ``*_penalty`` weights add linearised penalty terms (44)/(46) to the
    objective.  ``pin_zero_decode_queue`` adds q_d,i == 0 (the standing
    assumption of Section 5's zero-buffer router).
    """

    prefill_fairness_cap: Optional[float] = None  # eta_1
    decode_fairness_cap: Optional[float] = None  # eta_2
    tpot_cap: Optional[float] = None  # eta_3 (seconds / output token)
    prefill_fairness_penalty: float = 0.0  # eta_1'
    decode_fairness_penalty: float = 0.0  # eta_2'
    pin_zero_decode_queue: bool = False

    @property
    def active(self) -> bool:
        return (
            self.prefill_fairness_cap is not None
            or self.decode_fairness_cap is not None
            or self.tpot_cap is not None
            or self.prefill_fairness_penalty > 0
            or self.decode_fairness_penalty > 0
            or self.pin_zero_decode_queue
        )


@dataclass
class PlanSolution:
    """Optimal fluid plan + planning metadata used by the policies."""

    classes: tuple
    prim: ServicePrimitives
    pricing: Pricing
    objective: str  # "bundled" | "separate"
    x: np.ndarray  # per-class prefill occupancy targets  x_i*
    ym: np.ndarray
    ys: np.ndarray
    qp: np.ndarray
    qd: np.ndarray
    revenue_rate: float  # optimal per-server reward rate R*
    sli_value: float  # penalty part (0 if none)
    lp: LPResult = field(repr=False, default=None)
    dual_capacity: np.ndarray = None  # duals of the 3 capacity rows

    @property
    def x_total(self) -> float:
        return float(self.x.sum())

    def mixed_servers(self, n: int) -> int:
        """Static partition size M = ceil(n * sum_i x_i*) (Section 4.1)."""
        m = int(np.ceil(n * self.x_total - 1e-12))
        return min(max(m, 0), n)

    def solo_probs(self) -> np.ndarray:
        """Randomised-router probabilities p_{s,i} (Section 5.2)."""
        arr = rate_arrays(self.classes, self.prim)
        num = self.ys * arr["mu_s"]
        den = num + self.ym * arr["mu_m"]
        with np.errstate(invalid="ignore", divide="ignore"):
            p = np.where(den > 0, num / np.maximum(den, 1e-300), 1.0)
        return np.clip(p, 0.0, 1.0)


def _layout(I: int):
    """Column index helpers for the block layout [x, ym, ys, qp, qd, (aux)]."""
    return dict(x=0, ym=I, ys=2 * I, qp=3 * I, qd=4 * I, n=5 * I)


def _base_constraints(arr, B: float):
    I = arr["lam"].shape[0]
    L = _layout(I)
    n = L["n"]
    A_ub, b_ub, A_eq, b_eq = [], [], [], []

    row = np.zeros(n)
    row[L["x"] : L["x"] + I] = 1.0
    A_ub.append(row)
    b_ub.append(1.0)  # prefill capacity

    row = np.zeros(n)
    row[L["ym"] : L["ym"] + I] = 1.0
    row[L["x"] : L["x"] + I] = -(B - 1)
    A_ub.append(row)
    b_ub.append(0.0)  # mixed decode capacity

    row = np.zeros(n)
    row[L["ys"] : L["ys"] + I] = 1.0
    row[L["x"] : L["x"] + I] = B
    A_ub.append(row)
    b_ub.append(B)  # solo decode capacity

    for i in range(I):
        row = np.zeros(n)
        row[L["x"] + i] = arr["mu_p"][i]
        row[L["qp"] + i] = arr["theta"][i]
        A_eq.append(row)
        b_eq.append(arr["lam"][i])  # prefill flow balance
    for i in range(I):
        row = np.zeros(n)
        row[L["x"] + i] = arr["mu_p"][i]
        row[L["qd"] + i] = -arr["theta"][i]
        row[L["ym"] + i] = -arr["mu_m"][i]
        row[L["ys"] + i] = -arr["mu_s"][i]
        A_eq.append(row)
        b_eq.append(0.0)  # decode flow balance
    return A_ub, b_ub, A_eq, b_eq, L


def _add_sli(A_ub, b_ub, A_eq, b_eq, L, I, sli: SLISpec, prim: ServicePrimitives,
             n_cols: int):
    """Append SLI rows; returns (possibly widened) matrices + penalty vector."""
    B, tau, gamma = prim.batch_cap, prim.tau_mix, prim.gamma
    extra_cols = 0
    pen_fair_p = sli.prefill_fairness_penalty > 0
    pen_fair_d = sli.decode_fairness_penalty > 0
    col_tp = n_cols if pen_fair_p else None
    if pen_fair_p:
        extra_cols += 1
    col_td = n_cols + extra_cols if pen_fair_d else None
    if pen_fair_d:
        extra_cols += 1
    width = n_cols + extra_cols

    def wrow(r=None):
        out = np.zeros(width)
        if r is not None:
            out[: r.shape[0]] = r
        return out

    A_ub2 = [wrow(r) for r in A_ub]
    A_eq2 = [wrow(r) for r in A_eq]

    # Pairwise fairness caps: x_i - x_j <= eta (43) / ys_i - ys_j <= eta (45).
    if sli.prefill_fairness_cap is not None:
        for i in range(I):
            for j in range(I):
                if i == j:
                    continue
                row = wrow()
                row[L["x"] + i] = 1.0
                row[L["x"] + j] = -1.0
                A_ub2.append(row)
                b_ub.append(sli.prefill_fairness_cap)
    if sli.decode_fairness_cap is not None:
        for i in range(I):
            for j in range(I):
                if i == j:
                    continue
                row = wrow()
                row[L["ys"] + i] = 1.0
                row[L["ys"] + j] = -1.0
                A_ub2.append(row)
                b_ub.append(sli.decode_fairness_cap)

    # Penalty (soft) fairness: t >= x_i - x_j for all pairs; objective -= eta' t.
    for col, key, on in ((col_tp, "x", pen_fair_p), (col_td, "ys", pen_fair_d)):
        if not on:
            continue
        for i in range(I):
            for j in range(I):
                if i == j:
                    continue
                row = wrow()
                row[L[key] + i] = 1.0
                row[L[key] + j] = -1.0
                row[col] = -1.0
                A_ub2.append(row)
                b_ub.append(0.0)

    # TPOT cap (47): cross-multiplied linear constraint in X = sum_i x_i:
    #   tau (B-1) X + (B/gamma)(1-X) <= eta3 [ (B-1) X + B (1-X) ]
    if sli.tpot_cap is not None:
        eta = sli.tpot_cap
        coef_X = (tau * (B - 1) - B / gamma) - eta * ((B - 1) - B)
        const = eta * B - B / gamma
        row = wrow()
        row[L["x"] : L["x"] + I] = coef_X
        A_ub2.append(row)
        b_ub.append(const)

    if sli.pin_zero_decode_queue:
        for i in range(I):
            row = wrow()
            row[L["qd"] + i] = 1.0
            A_eq2.append(row)
            b_eq.append(0.0)

    pen = np.zeros(width)
    if pen_fair_p:
        pen[col_tp] = sli.prefill_fairness_penalty
    if pen_fair_d:
        pen[col_td] = sli.decode_fairness_penalty
    return A_ub2, b_ub, A_eq2, b_eq, width, pen


def _solve(
    classes: Sequence[WorkloadClass],
    prim: ServicePrimitives,
    pricing: Pricing,
    objective: str,
    sli: Optional[SLISpec] = None,
    capacity: float = 1.0,
) -> PlanSolution:
    classes = validate_planning_instance(
        classes, capacity, label=f"planning LP ({objective})")
    prim = resolve_primitives(prim)
    arr = rate_arrays(classes, prim)
    if capacity != 1.0:  # uniform server-speed scale (elasticity studies)
        arr = dict(arr)
        for k in ("mu_p", "mu_m", "mu_s"):
            arr[k] = arr[k] * capacity
    I = len(classes)
    B = float(prim.batch_cap)
    A_ub, b_ub, A_eq, b_eq, L = _base_constraints(arr, B)
    n_cols = L["n"]
    pen = np.zeros(n_cols)
    if sli is not None and sli.active:
        A_ub, b_ub, A_eq, b_eq, n_cols, pen = _add_sli(
            A_ub, b_ub, A_eq, b_eq, L, I, sli, prim, n_cols
        )

    c = np.zeros(n_cols)
    if objective == "bundled":
        w = np.array([pricing.bundled_reward(k) for k in classes])
        c[L["ym"] : L["ym"] + I] = w * arr["mu_m"]
        c[L["ys"] : L["ys"] + I] = w * arr["mu_s"]
    elif objective == "separate":
        # Eq. (42): coefficients are class independent.
        c[L["x"] : L["x"] + I] = pricing.c_p * prim.chunk / prim.tau_mix
        c[L["ym"] : L["ym"] + I] = pricing.c_d / prim.tau_mix
        c[L["ys"] : L["ys"] + I] = pricing.c_d * prim.gamma
    else:
        raise ValueError(objective)
    c -= pen

    from .lp import LPInfeasible

    try:
        res = linprog_max(c, np.array(A_ub), np.array(b_ub), np.array(A_eq),
                          np.array(b_eq))
    except LPInfeasible as exc:
        # Enrich the bare phase-1 residual with the planning instance:
        # with theta_i = 0 the prefill flow balance pins x_i = lam_i/mu_p_i,
        # so overload (sum of pinned x_i > 1) is the canonical cause.
        zero_theta = arr["theta"] <= 0
        pinned = np.where(zero_theta, arr["lam"] / arr["mu_p"], 0.0)
        raise LPInfeasible(
            f"planning LP ({objective}) infeasible for I={I} classes "
            f"(B={B:g}): {exc}; lam={np.round(arr['lam'], 6).tolist()}, "
            f"theta={np.round(arr['theta'], 6).tolist()}; zero-patience "
            f"classes pin x_i = lam_i/mu_p_i with total pinned prefill "
            f"occupancy {float(pinned.sum()):.4g} (must be <= 1)") from exc
    x = res.x
    sol_pen = float(pen @ x)
    plan = PlanSolution(
        classes=classes,
        prim=prim,
        pricing=pricing,
        objective=objective,
        x=x[L["x"] : L["x"] + I].copy(),
        ym=x[L["ym"] : L["ym"] + I].copy(),
        ys=x[L["ys"] : L["ys"] + I].copy(),
        qp=x[L["qp"] : L["qp"] + I].copy(),
        qd=x[L["qd"] : L["qd"] + I].copy(),
        revenue_rate=float(res.fun + sol_pen),  # revenue part (before penalty)
        sli_value=sol_pen,
        lp=res,
        dual_capacity=res.dual_ub[:3].copy(),
    )
    return plan


def solve_bundled_lp(
    classes: Sequence[WorkloadClass],
    prim: ServicePrimitives = None,
    pricing: Pricing = None,
    sli: Optional[SLISpec] = None,
    capacity: float = 1.0,
) -> PlanSolution:
    """Solve the bundled-charging steady-state LP (40) (+ optional SLI rows)."""
    prim = prim or ServicePrimitives()
    pricing = pricing or Pricing()
    return _solve(classes, prim, pricing, "bundled", sli, capacity)


def solve_separate_lp(
    classes: Sequence[WorkloadClass],
    prim: ServicePrimitives = None,
    pricing: Pricing = None,
    sli: Optional[SLISpec] = None,
    capacity: float = 1.0,
) -> PlanSolution:
    """Solve the separate-charging steady-state LP (42) (+ optional SLI rows)."""
    prim = prim or ServicePrimitives()
    pricing = pricing or Pricing()
    return _solve(classes, prim, pricing, "separate", sli, capacity)


def solve_plan(classes, prim=None, pricing=None, objective="bundled",
               sli: Optional[SLISpec] = None,
               capacity: float = 1.0) -> PlanSolution:
    """Front door of the planning layer (``capacity`` uniformly scales the
    service rates; ``capacity <= 0`` raises a diagnostic LPInfeasible)."""
    if objective == "bundled":
        return solve_bundled_lp(classes, prim, pricing, sli, capacity)
    return solve_separate_lp(classes, prim, pricing, sli, capacity)


def tpot_of_plan(plan: PlanSolution) -> float:
    """Average time-per-output-token of a plan, Eq. (47)'s left-hand side."""
    prim = plan.prim
    B, tau, gamma = prim.batch_cap, prim.tau_mix, prim.gamma
    X = plan.x_total
    num = tau * (B - 1) * X + (1.0 / gamma) * B * (1 - X)
    den = (B - 1) * X + B * (1 - X)
    return num / den if den > 0 else float("nan")
