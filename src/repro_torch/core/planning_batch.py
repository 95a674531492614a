"""Batched assembly + solve of the steady-state planning LPs (Eqs. 40/42).

Stacks the planning constraint blocks of MANY instances -- workload-class
configurations, pricing points, patience (theta) values, capacity scales,
SLI caps -- into (S, m, n) tensors and solves them in ONE batched interior-point
run (:func:`repro_torch.core.lp_jax.solve_lp_batch`), on the card unless
the caller passes ``device="cpu"``.  The serial
:func:`repro_torch.core.planning.solve_plan` simplex stays the semantics
oracle; controller replans (and, once ported, sweep grids, closed-loop
hindsight plans and SLI cap sweeps) batch through here.

Block layout per instance (identical to :mod:`repro_torch.core.planning`):

    columns  [x(I) | ym(I) | ys(I) | qp(I) | qd(I) | aux(penalty)]
    ub rows  [3 capacity | fairness caps | penalty pairs | TPOT]
    eq rows  [I prefill flow balance | I decode flow balance | I q_d pin]

Instances with fewer classes than the batch maximum are padded with a
negligible filler class (``lam = PAD_LAM``, ``theta = 1``) whose
occupancy/revenue contribution is below the solver tolerance; results
are sliced back to each instance's true class count, and pairwise SLI
rows that would reference a filler class are neutralised per instance
(the filler must never act as an absolute fairness anchor).

SLI support matches :class:`repro_torch.core.planning.SLISpec`, with the cap
fields (``prefill_fairness_cap`` / ``decode_fairness_cap`` /
``tpot_cap``) additionally accepting length-S arrays -- what
``bench_sli_pareto`` uses to solve a whole Pareto frontier in one call.
Penalty weights and ``pin_zero_decode_queue`` are static per batch
(they change the block *structure*, not just values).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .lp_jax import DEFAULT_ITERS, DEFAULT_TOL, solve_lp_batch
from .planning import PlanSolution, SLISpec, validate_planning_instance
from .types import Pricing, ServicePrimitives, WorkloadClass, rate_arrays

__all__ = ["PlanBatch", "solve_plan_batch", "solve_plan_jax", "PAD_LAM",
           "HeteroPlanBatch", "HeteroPlanSolution", "solve_hetero_batch",
           "solve_hetero_plan"]

PAD_LAM = 1e-9  # filler-class arrival rate (keeps padded rows nonsingular)


def _cap_array(v, S: int, name: str) -> Optional[np.ndarray]:
    if v is None:
        return None
    out = np.broadcast_to(np.asarray(v, dtype=np.float64), (S,)).copy()
    if not np.all(np.isfinite(out)):
        raise ValueError(f"{name}: caps must be finite, got {out}")
    return out


@dataclass
class PlanBatch:
    """Stacked plan solutions + solver diagnostics for S instances."""

    objective: str
    instances: tuple  # per-instance class tuples (unpadded)
    prims: tuple
    pricings: tuple
    x: np.ndarray  # (S, I_max)
    ym: np.ndarray
    ys: np.ndarray
    qp: np.ndarray
    qd: np.ndarray
    revenue_rate: np.ndarray  # (S,) revenue part (penalty added back)
    sli_value: np.ndarray  # (S,) penalty part (0 without penalties)
    dual_capacity: np.ndarray  # (S, 3) duals of the capacity rows
    primal_res: np.ndarray  # (S,) solver diagnostics (relative)
    dual_res: np.ndarray
    gap: np.ndarray
    converged: np.ndarray  # (S,) bool
    n_iter: np.ndarray  # (S,)
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.instances)

    def solution(self, k: int) -> PlanSolution:
        """Instance ``k`` as a :class:`PlanSolution` (padding sliced off);
        drop-in for the policy constructors, ``lp`` left ``None``."""
        I = len(self.instances[k])
        return PlanSolution(
            classes=self.instances[k],
            prim=self.prims[k],
            pricing=self.pricings[k],
            objective=self.objective,
            x=self.x[k, :I].copy(),
            ym=self.ym[k, :I].copy(),
            ys=self.ys[k, :I].copy(),
            qp=self.qp[k, :I].copy(),
            qd=self.qd[k, :I].copy(),
            revenue_rate=float(self.revenue_rate[k]),
            sli_value=float(self.sli_value[k]),
            lp=None,
            dual_capacity=self.dual_capacity[k].copy(),
        )

    def solutions(self) -> list:
        return [self.solution(k) for k in range(len(self))]

    def require_converged(self, label: str = "planning batch") -> "PlanBatch":
        """Raise a diagnostic LPInfeasible unless every instance converged.

        The batched IPM does not raise per instance, so
        infeasible/unbounded instances surface as ``converged == False``;
        every entry point that hands plans to a *policy*
        (``solve_plan_jax``, the controller replan paths) must funnel
        through this so a garbage plan is never published -- matching the
        simplex oracle's eager LPInfeasible.
        """
        from .lp import LPInfeasible

        if bool(np.all(self.converged)):
            return self
        bad = np.nonzero(~np.asarray(self.converged, dtype=bool))[0]
        detail = ", ".join(
            f"[{k}] primal={self.primal_res[k]:.2e} "
            f"dual={self.dual_res[k]:.2e} gap={self.gap[k]:.2e}"
            for k in bad[:4])
        raise LPInfeasible(
            f"{label} ({self.objective}): {bad.size}/{len(self)} instances "
            f"did not converge within the fixed iteration budget "
            f"({detail}{', ...' if bad.size > 4 else ''}); the instance is "
            f"likely infeasible or unbounded -- the serial solve_plan "
            f"oracle raises eagerly on the same input")


def _pad_instances(instances) -> tuple:
    """Equalise class counts with a negligible filler class."""
    I_max = max(len(cl) for cl in instances)
    filler = WorkloadClass("__pad__", prompt_len=1.0, decode_len=1.0,
                           arrival_rate=PAD_LAM, patience=1.0)
    return tuple(tuple(cl) + (filler,) * (I_max - len(cl))
                 for cl in instances), I_max


def _stack_arrays(padded, prims, capacity) -> dict:
    """(S, I) parameter tensors from the padded instances."""
    arrs = [rate_arrays(cl, prim) for cl, prim in zip(padded, prims)]
    out = {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}
    if capacity is not None:
        for k in ("mu_p", "mu_m", "mu_s"):
            out[k] = out[k] * capacity[:, None]
    return out


def _assemble(arr, prim_B, prim_tau, prim_gamma, prim_chunk, cp, cd,
              objective: str, sli: Optional[SLISpec], I_per):
    """Stacked (c, A_ub, b_ub, A_eq, b_eq) planning tensors.

    ``arr`` holds (S, I) arrays; the prim/pricing arguments are (S,)
    arrays and ``I_per`` the per-instance TRUE class counts.  Row/column
    order mirrors :mod:`repro_torch.core.planning` exactly (capacity rows
    first, so ``dual_ub[:, :3]`` are the capacity shadow prices there
    too).  Pairwise SLI rows touching a padded class are neutralised
    per instance (zero row, slack rhs) -- a filler class's x ~ 0 would
    otherwise turn ``x_i - x_pad <= cap`` into an absolute cap that the
    unpadded LP does not have.
    """
    S, I = arr["lam"].shape
    I_per = np.asarray(I_per, dtype=int)
    ix, iym, iys, iqp, iqd = (np.arange(I), I + np.arange(I),
                              2 * I + np.arange(I), 3 * I + np.arange(I),
                              4 * I + np.arange(I))
    n_base = 5 * I

    pen_p = sli is not None and np.any(sli.prefill_fairness_penalty > 0)
    pen_d = sli is not None and np.any(sli.decode_fairness_penalty > 0)
    col_tp = n_base if pen_p else None
    col_td = n_base + int(pen_p) if pen_d else None
    n_cols = n_base + int(pen_p) + int(pen_d)

    pairs = [(i, j) for i in range(I) for j in range(I) if i != j]

    A_ub, b_ub = [], []

    def ub_row(cols, vals, rhs, real=None):
        """One <= row pattern; ``vals`` entries broadcast to (S,).

        ``real`` masks the row OFF (zero coefficients, rhs 1) for
        instances where it references a padded class.
        """
        row = np.zeros((S, n_cols))
        rhs = np.broadcast_to(np.asarray(rhs, dtype=np.float64), (S,)).copy()
        for c, v in zip(cols, vals):
            row[:, c] = np.broadcast_to(v, (S,))
        if real is not None:
            row[~real, :] = 0.0
            rhs[~real] = 1.0  # 0 <= 1: trivially slack
        A_ub.append(row)
        b_ub.append(rhs)

    B = prim_B
    ub_row(ix, [1.0] * I, 1.0)  # prefill capacity
    row = np.zeros((S, n_cols))
    row[:, iym] = 1.0
    row[:, ix] = -(B - 1.0)[:, None]
    A_ub.append(row)
    b_ub.append(np.zeros(S))  # mixed decode capacity
    row = np.zeros((S, n_cols))
    row[:, iys] = 1.0
    row[:, ix] = B[:, None]
    A_ub.append(row)
    b_ub.append(B.copy())  # solo decode capacity

    cap_p = _cap_array(sli.prefill_fairness_cap, S,
                       "prefill_fairness_cap") if sli else None
    cap_d = _cap_array(sli.decode_fairness_cap, S,
                       "decode_fairness_cap") if sli else None
    cap_t = _cap_array(sli.tpot_cap, S, "tpot_cap") if sli else None
    pair_real = {(i, j): (I_per > max(i, j)) for i, j in pairs}
    if cap_p is not None:
        for i, j in pairs:
            ub_row([ix[i], ix[j]], [1.0, -1.0], cap_p, real=pair_real[i, j])
    if cap_d is not None:
        for i, j in pairs:
            ub_row([iys[i], iys[j]], [1.0, -1.0], cap_d,
                   real=pair_real[i, j])
    for col, block, on in ((col_tp, ix, pen_p), (col_td, iys, pen_d)):
        if not on:
            continue
        for i, j in pairs:
            ub_row([block[i], block[j], col], [1.0, -1.0, -1.0], 0.0,
                   real=pair_real[i, j])
    if cap_t is not None:
        # TPOT cap (47), cross-multiplied; coefficient on every x column.
        coef = ((prim_tau * (B - 1.0) - B / prim_gamma)
                - cap_t * ((B - 1.0) - B))
        row = np.zeros((S, n_cols))
        row[:, ix] = coef[:, None]
        A_ub.append(row)
        b_ub.append(cap_t * B - B / prim_gamma)

    eq_rows, b_eq = [], []
    for i in range(I):
        row = np.zeros((S, n_cols))
        row[:, ix[i]] = arr["mu_p"][:, i]
        row[:, iqp[i]] = arr["theta"][:, i]
        eq_rows.append(row)
        b_eq.append(arr["lam"][:, i])  # prefill flow balance
    for i in range(I):
        row = np.zeros((S, n_cols))
        row[:, ix[i]] = arr["mu_p"][:, i]
        row[:, iqd[i]] = -arr["theta"][:, i]
        row[:, iym[i]] = -arr["mu_m"][:, i]
        row[:, iys[i]] = -arr["mu_s"][:, i]
        eq_rows.append(row)
        b_eq.append(np.zeros(S))  # decode flow balance
    if sli is not None and sli.pin_zero_decode_queue:
        for i in range(I):
            row = np.zeros((S, n_cols))
            row[:, iqd[i]] = 1.0
            eq_rows.append(row)
            b_eq.append(np.zeros(S))

    c = np.zeros((S, n_cols))
    if objective == "bundled":
        w = cp[:, None] * arr["P"] + cd[:, None] * arr["D"]  # Eq. (21)
        c[:, iym] = w * arr["mu_m"]
        c[:, iys] = w * arr["mu_s"]
    elif objective == "separate":
        c[:, ix] = (cp * prim_chunk / prim_tau)[:, None]
        c[:, iym] = (cd / prim_tau)[:, None]
        c[:, iys] = (cd * prim_gamma)[:, None]
    else:
        raise ValueError(objective)
    pen = np.zeros((S, n_cols))
    if pen_p:
        pen[:, col_tp] = np.broadcast_to(sli.prefill_fairness_penalty, (S,))
    if pen_d:
        pen[:, col_td] = np.broadcast_to(sli.decode_fairness_penalty, (S,))
    c = c - pen

    return (c, np.stack(A_ub, axis=1), np.stack(b_ub, axis=1),
            np.stack(eq_rows, axis=1), np.stack(b_eq, axis=1), pen)


def solve_plan_batch(
    instances: Sequence[Sequence[WorkloadClass]],
    prim: Optional[ServicePrimitives] = None,
    pricing: Optional[Pricing] = None,
    *,
    objective: str = "bundled",
    sli: Optional[SLISpec] = None,
    prims: Optional[Sequence[ServicePrimitives]] = None,
    pricings: Optional[Sequence[Pricing]] = None,
    capacity=None,
    iters: int = DEFAULT_ITERS,
    tol: float = DEFAULT_TOL,
    device=None,
) -> PlanBatch:
    """Solve the planning LP for every instance in ONE batched IPM run.

    ``instances`` is a sequence of workload-class sequences (class counts
    may differ; padding is internal).  ``prims`` / ``pricings`` override
    the shared ``prim`` / ``pricing`` per instance; ``capacity`` is an
    optional length-S uniform service-rate scale.  Degenerate instances
    (empty, zero traffic, nonpositive capacity) raise the same
    diagnostic :class:`repro_torch.core.lp.LPInfeasible` as the serial
    oracle.  ``device`` (the card by default) runs the solve.
    """
    instances = [tuple(cl) for cl in instances]
    S = len(instances)
    if S == 0:
        raise ValueError("solve_plan_batch needs at least one instance")
    prims = tuple(prims) if prims is not None else (
        (prim or ServicePrimitives(),) * S)
    pricings = tuple(pricings) if pricings is not None else (
        (pricing or Pricing(),) * S)
    if len(prims) != S or len(pricings) != S:
        raise ValueError("prims/pricings must match the instance count")
    capacity = (np.broadcast_to(np.asarray(capacity, dtype=np.float64),
                                (S,)).copy()
                if capacity is not None else None)
    for k, cl in enumerate(instances):
        validate_planning_instance(
            cl, 1.0 if capacity is None else float(capacity[k]),
            label=f"planning LP batch[{k}] ({objective})")

    padded, I_max = _pad_instances(instances)
    arr = _stack_arrays(padded, prims, capacity)
    to_f = lambda vals: np.array(vals, dtype=np.float64)  # noqa: E731
    c, A_ub, b_ub, A_eq, b_eq, pen = _assemble(
        arr,
        to_f([p.batch_cap for p in prims]),
        to_f([p.tau_mix for p in prims]),
        to_f([p.gamma for p in prims]),
        to_f([p.chunk for p in prims]),
        to_f([p.c_p for p in pricings]),
        to_f([p.c_d for p in pricings]),
        objective, sli, [len(cl) for cl in instances])

    res = solve_lp_batch(c, A_ub, b_ub, A_eq, b_eq, iters=iters, tol=tol,
                         device=device)
    sol_pen = np.einsum("sj,sj->s", pen, res.x)
    blk = lambda j: res.x[:, j * I_max:(j + 1) * I_max]  # noqa: E731
    return PlanBatch(
        objective=objective,
        instances=tuple(instances),
        prims=prims,
        pricings=pricings,
        x=blk(0), ym=blk(1), ys=blk(2), qp=blk(3), qd=blk(4),
        revenue_rate=res.fun + sol_pen,
        sli_value=sol_pen,
        dual_capacity=res.dual_ub[:, :3],
        primal_res=res.primal_res,
        dual_res=res.dual_res,
        gap=res.gap,
        converged=res.converged,
        n_iter=res.n_iter,
        meta={"iters": int(iters), "tol": float(tol), "I_max": int(I_max),
              "n_ub": int(A_ub.shape[1]), "n_eq": int(A_eq.shape[1])},
    )


def solve_plan_jax(classes, prim=None, pricing=None, objective="bundled",
                   sli: Optional[SLISpec] = None, capacity: float = 1.0,
                   iters: int = DEFAULT_ITERS,
                   tol: float = DEFAULT_TOL, device=None) -> PlanSolution:
    """Single-instance planning solve on the fixed-iteration path.

    Call-compatible with :func:`repro_torch.core.planning.solve_plan`,
    including raising :class:`repro_torch.core.lp.LPInfeasible` when the
    instance does not admit a converged plan.
    """
    pb = solve_plan_batch(
        [tuple(classes)], prim, pricing, objective=objective, sli=sli,
        capacity=None if capacity == 1.0 else [capacity],
        iters=iters, tol=tol, device=device)
    return pb.require_converged("solve_plan_jax").solution(0)


# ---------------------------------------------------------------------------
# Heterogeneous fleets: class-indexed capacity row groups
# ---------------------------------------------------------------------------
#
# Per-instance column layout (C server classes, I workload classes):
#
#     [x(C*I) | ym(C*I) | ys(C*I) | qp(I) | qd(I)]      x[c,i] at c*I + i
#
#     ub rows  [class-0 capacity triple | class-1 triple | ... ]  (3C rows)
#     eq rows  [I prefill flow balance | I decode flow balance]
#
# Each class keeps its OWN capacity triple (sum_i x[c,i] <= 1 etc.) --
# servers of different GPU classes cannot trade occupancy -- while the
# flow-balance rows couple the classes through fleet shares w_c = n_c/n:
# a class-c server contributes w_c of the fleet-average per-server rate.
# With C = 1 (w = 1) the tensors reduce bitwise to the homogeneous
# Eq. 40/42 assembly above.


@dataclass
class HeteroPlanSolution:
    """Heterogeneous fluid plan: per-(class c, workload i) occupancies."""

    classes: tuple
    prims: tuple  # per-server-class ServicePrimitives
    weights: np.ndarray  # (C,) fleet shares n_c / n
    kv_xfers: np.ndarray  # (C,) KV transfer seconds per prompt token
    pricing: Pricing
    objective: str  # "bundled" | "separate"
    x: np.ndarray  # (C, I)
    ym: np.ndarray  # (C, I)
    ys: np.ndarray  # (C, I)
    qp: np.ndarray  # (I,) shared fluid queues (per fleet-average server)
    qd: np.ndarray
    revenue_rate: float  # fleet-average per-server R*
    dual_capacity: np.ndarray = None  # (C, 3) capacity shadow prices

    @property
    def n_server_classes(self) -> int:
        return len(self.prims)

    def rate_tensors(self) -> dict:
        """(C, I) mu tensors (transfer-adjusted mu_p), plus lam/theta/P/D."""
        arrs = [rate_arrays(self.classes, p, kv_xfer=float(k))
                for p, k in zip(self.prims, self.kv_xfers)]
        out = {k: np.stack([a[k] for a in arrs]) for k in
               ("mu_p", "mu_m", "mu_s")}
        out.update({k: arrs[0][k] for k in ("lam", "theta", "P", "D")})
        return out

    def split_probs(self) -> np.ndarray:
        """(C, I) routing split: class-i arrivals go to pool c w.p. p_ci.

        Proportional to each pool's planned prefill throughput
        ``w_c mu_p[c,i] x[c,i]`` -- the fluid-optimal split, since any
        other split starves one pool's planned occupancy.  Workload
        classes the plan rejects entirely (zero column) fall back to a
        fleet-share split so the gate still sees them arrive.
        """
        arr = self.rate_tensors()
        num = self.weights[:, None] * arr["mu_p"] * self.x
        den = num.sum(axis=0, keepdims=True)
        fallback = np.broadcast_to(self.weights[:, None], num.shape)
        return np.where(den > 0, num / np.maximum(den, 1e-300), fallback)

    def pool_plan(self, c: int) -> PlanSolution:
        """Class-c pool projected to a homogeneous :class:`PlanSolution`.

        Per-pool-server occupancy targets are ``x[c]`` directly; the
        shared fluid queues are split by the pool's routing share and
        rescaled from per-fleet-server to per-pool-server units
        (``p_ci / w_c``).  Feed this to ``gate_and_route`` to get the
        class-aware policy for the pool's ``n_c`` servers.
        """
        w_c = float(self.weights[c])
        p_c = self.split_probs()[c]
        arr = self.rate_tensors()
        wi = (self.pricing.c_p * arr["P"] + self.pricing.c_d * arr["D"])
        if self.objective == "bundled":
            rev = float(np.sum(wi * (arr["mu_m"][c] * self.ym[c]
                                     + arr["mu_s"][c] * self.ys[c])))
        else:
            rev = float(np.sum(
                self.pricing.c_p * arr["P"] * arr["mu_p"][c] * self.x[c]
                + self.pricing.c_d * arr["D"] * (arr["mu_m"][c] * self.ym[c]
                                                 + arr["mu_s"][c]
                                                 * self.ys[c])))
        return PlanSolution(
            classes=self.classes,
            prim=self.prims[c],
            pricing=self.pricing,
            objective=self.objective,
            x=self.x[c].copy(),
            ym=self.ym[c].copy(),
            ys=self.ys[c].copy(),
            qp=self.qp * p_c / w_c,
            qd=self.qd * p_c / w_c,
            revenue_rate=rev,
            sli_value=0.0,
            lp=None,
            dual_capacity=(None if self.dual_capacity is None
                           else self.dual_capacity[c].copy()),
        )


@dataclass
class HeteroPlanBatch:
    """Stacked heterogeneous plans + solver diagnostics for S instances."""

    objective: str
    instances: tuple  # per-instance class tuples (unpadded)
    fleets: tuple  # per-instance tuples of (weight, prim, kv_xfer)
    pricings: tuple
    x: np.ndarray  # (S, C, I_max)
    ym: np.ndarray
    ys: np.ndarray
    qp: np.ndarray  # (S, I_max)
    qd: np.ndarray
    revenue_rate: np.ndarray  # (S,)
    dual_capacity: np.ndarray  # (S, C, 3)
    primal_res: np.ndarray
    dual_res: np.ndarray
    gap: np.ndarray
    converged: np.ndarray
    n_iter: np.ndarray
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.instances)

    def solution(self, k: int) -> HeteroPlanSolution:
        I = len(self.instances[k])
        fl = self.fleets[k]
        return HeteroPlanSolution(
            classes=self.instances[k],
            prims=tuple(p for _, p, _ in fl),
            weights=np.array([w for w, _, _ in fl], dtype=np.float64),
            kv_xfers=np.array([x for _, _, x in fl], dtype=np.float64),
            pricing=self.pricings[k],
            objective=self.objective,
            x=self.x[k, :, :I].copy(),
            ym=self.ym[k, :, :I].copy(),
            ys=self.ys[k, :, :I].copy(),
            qp=self.qp[k, :I].copy(),
            qd=self.qd[k, :I].copy(),
            revenue_rate=float(self.revenue_rate[k]),
            dual_capacity=self.dual_capacity[k].copy(),
        )

    def solutions(self) -> list:
        return [self.solution(k) for k in range(len(self))]

    def require_converged(self,
                          label: str = "hetero planning batch"
                          ) -> "HeteroPlanBatch":
        from .lp import LPInfeasible

        if bool(np.all(self.converged)):
            return self
        bad = np.nonzero(~np.asarray(self.converged, dtype=bool))[0]
        detail = ", ".join(
            f"[{k}] primal={self.primal_res[k]:.2e} "
            f"dual={self.dual_res[k]:.2e} gap={self.gap[k]:.2e}"
            for k in bad[:4])
        raise LPInfeasible(
            f"{label} ({self.objective}): {bad.size}/{len(self)} instances "
            f"did not converge within the fixed iteration budget ({detail}"
            f"{', ...' if bad.size > 4 else ''})")


def _normalize_fleet(fleet) -> tuple:
    """Validate one instance's ((weight, prim, kv_xfer), ...) triples."""
    fl = tuple((float(w), p, float(x)) for w, p, x in fleet)
    if not fl:
        raise ValueError("hetero fleet needs at least one server class")
    tot = sum(w for w, _, _ in fl)
    if not np.isfinite(tot) or tot <= 0:
        raise ValueError(f"fleet weights must sum positive, got {tot}")
    if any(w < 0 for w, _, _ in fl):
        raise ValueError("fleet weights must be nonnegative")
    if any(x < 0 or not np.isfinite(x) for _, _, x in fl):
        raise ValueError("kv_xfer must be finite and nonnegative")
    return tuple((w / tot, p, x) for w, p, x in fl)


def _assemble_hetero(arr, weights, B_c, cp, cd, objective: str):
    """Stacked hetero (c, A_ub, b_ub, A_eq, b_eq) tensors.

    ``arr["mu_*"]`` are (S, C, I); ``weights`` / ``B_c`` are (S, C);
    ``cp`` / ``cd`` are (S,).  Capacity rows come first, group-major per
    server class, so ``dual_ub[:, :3C].reshape(S, C, 3)`` are the
    per-class capacity shadow prices.
    """
    S, C, I = arr["mu_p"].shape
    CI = C * I
    x_at = lambda c: c * I + np.arange(I)  # noqa: E731
    ym_at = lambda c: CI + c * I + np.arange(I)  # noqa: E731
    ys_at = lambda c: 2 * CI + c * I + np.arange(I)  # noqa: E731
    iqp = 3 * CI + np.arange(I)
    iqd = 3 * CI + I + np.arange(I)
    n_cols = 3 * CI + 2 * I

    A_ub, b_ub = [], []
    for c in range(C):
        B = B_c[:, c]
        row = np.zeros((S, n_cols))
        row[:, x_at(c)] = 1.0
        A_ub.append(row)
        b_ub.append(np.ones(S))  # prefill capacity, class c
        row = np.zeros((S, n_cols))
        row[:, ym_at(c)] = 1.0
        row[:, x_at(c)] = -(B - 1.0)[:, None]
        A_ub.append(row)
        b_ub.append(np.zeros(S))  # mixed decode capacity, class c
        row = np.zeros((S, n_cols))
        row[:, ys_at(c)] = 1.0
        row[:, x_at(c)] = B[:, None]
        A_ub.append(row)
        b_ub.append(B.copy())  # solo decode capacity, class c

    eq_rows, b_eq = [], []
    for i in range(I):
        row = np.zeros((S, n_cols))
        for c in range(C):
            row[:, x_at(c)[i]] = weights[:, c] * arr["mu_p"][:, c, i]
        row[:, iqp[i]] = arr["theta"][:, i]
        eq_rows.append(row)
        b_eq.append(arr["lam"][:, i])  # prefill flow balance
    for i in range(I):
        row = np.zeros((S, n_cols))
        for c in range(C):
            w = weights[:, c]
            row[:, x_at(c)[i]] = w * arr["mu_p"][:, c, i]
            row[:, ym_at(c)[i]] = -w * arr["mu_m"][:, c, i]
            row[:, ys_at(c)[i]] = -w * arr["mu_s"][:, c, i]
        row[:, iqd[i]] = -arr["theta"][:, i]
        eq_rows.append(row)
        b_eq.append(np.zeros(S))  # decode flow balance

    c_obj = np.zeros((S, n_cols))
    if objective == "bundled":
        wi = cp[:, None] * arr["P"] + cd[:, None] * arr["D"]  # (S, I)
        for c in range(C):
            w = weights[:, c][:, None]
            c_obj[:, ym_at(c)] = wi * w * arr["mu_m"][:, c]
            c_obj[:, ys_at(c)] = wi * w * arr["mu_s"][:, c]
    elif objective == "separate":
        for c in range(C):
            w = weights[:, c][:, None]
            c_obj[:, x_at(c)] = (cp[:, None] * arr["P"] * w
                                 * arr["mu_p"][:, c])
            c_obj[:, ym_at(c)] = (cd[:, None] * arr["D"] * w
                                  * arr["mu_m"][:, c])
            c_obj[:, ys_at(c)] = (cd[:, None] * arr["D"] * w
                                  * arr["mu_s"][:, c])
    else:
        raise ValueError(objective)

    return (c_obj, np.stack(A_ub, axis=1), np.stack(b_ub, axis=1),
            np.stack(eq_rows, axis=1), np.stack(b_eq, axis=1))


def solve_hetero_batch(
    instances: Sequence[Sequence[WorkloadClass]],
    fleets: Sequence[Sequence[tuple]],
    pricing: Optional[Pricing] = None,
    *,
    objective: str = "bundled",
    pricings: Optional[Sequence[Pricing]] = None,
    iters: int = DEFAULT_ITERS,
    tol: float = DEFAULT_TOL,
    device=None,
) -> HeteroPlanBatch:
    """Batched heterogeneous planning solve (class-indexed capacity rows).

    ``fleets[s]`` is a sequence of ``(weight, prim, kv_xfer)`` triples --
    one per server class -- with weights the fleet shares ``n_c / n``
    (normalised here) and ``kv_xfer`` the KV handoff seconds per prompt
    token for that class.  All instances in one batch must share the
    same class count C.  :meth:`repro_torch.core.hetero.FleetSpec.
    planner_fleet` produces the triples from a declarative fleet spec.
    ``device`` (the card by default) runs the solve.
    """
    instances = [tuple(cl) for cl in instances]
    S = len(instances)
    if S == 0:
        raise ValueError("solve_hetero_batch needs at least one instance")
    fleets = tuple(_normalize_fleet(fl) for fl in fleets)
    if len(fleets) != S:
        raise ValueError("fleets must match the instance count")
    C = len(fleets[0])
    if any(len(fl) != C for fl in fleets):
        raise ValueError("all instances in a hetero batch must share the "
                         "same server-class count")
    pricings = tuple(pricings) if pricings is not None else (
        (pricing or Pricing(),) * S)
    if len(pricings) != S:
        raise ValueError("pricings must match the instance count")
    for k, cl in enumerate(instances):
        validate_planning_instance(
            cl, 1.0, label=f"hetero planning batch[{k}] ({objective})")

    padded, I_max = _pad_instances(instances)
    # (S, C, I) mu tensors: one rate_arrays call per (instance, class).
    per_sc = [[rate_arrays(cl, p, kv_xfer=x) for _, p, x in fl]
              for cl, fl in zip(padded, fleets)]
    arr = {k: np.stack([np.stack([a[k] for a in row]) for row in per_sc])
           for k in ("mu_p", "mu_m", "mu_s")}
    for k in ("lam", "theta", "P", "D"):
        arr[k] = np.stack([row[0][k] for row in per_sc])
    to_f = lambda vals: np.array(vals, dtype=np.float64)  # noqa: E731
    c, A_ub, b_ub, A_eq, b_eq = _assemble_hetero(
        arr,
        to_f([[w for w, _, _ in fl] for fl in fleets]),
        to_f([[p.batch_cap for _, p, _ in fl] for fl in fleets]),
        to_f([p.c_p for p in pricings]),
        to_f([p.c_d for p in pricings]),
        objective)

    res = solve_lp_batch(c, A_ub, b_ub, A_eq, b_eq, iters=iters, tol=tol,
                         device=device)
    CI = C * I_max
    xcol = res.x[:, :CI].reshape(S, C, I_max)
    ymcol = res.x[:, CI:2 * CI].reshape(S, C, I_max)
    yscol = res.x[:, 2 * CI:3 * CI].reshape(S, C, I_max)
    return HeteroPlanBatch(
        objective=objective,
        instances=tuple(instances),
        fleets=fleets,
        pricings=pricings,
        x=xcol, ym=ymcol, ys=yscol,
        qp=res.x[:, 3 * CI:3 * CI + I_max],
        qd=res.x[:, 3 * CI + I_max:3 * CI + 2 * I_max],
        revenue_rate=res.fun,
        dual_capacity=res.dual_ub[:, :3 * C].reshape(S, C, 3),
        primal_res=res.primal_res,
        dual_res=res.dual_res,
        gap=res.gap,
        converged=res.converged,
        n_iter=res.n_iter,
        meta={"iters": int(iters), "tol": float(tol), "I_max": int(I_max),
              "C": int(C), "n_ub": int(A_ub.shape[1]),
              "n_eq": int(A_eq.shape[1])},
    )


def solve_hetero_plan(classes, fleet, pricing=None, *,
                      objective: str = "bundled",
                      iters: int = DEFAULT_ITERS,
                      tol: float = DEFAULT_TOL,
                      device=None) -> HeteroPlanSolution:
    """Single-instance heterogeneous planning solve (raises on
    non-convergence, like :func:`solve_plan_jax`)."""
    hb = solve_hetero_batch([tuple(classes)], [tuple(fleet)], pricing,
                            objective=objective, iters=iters, tol=tol,
                            device=device)
    return hb.require_converged("solve_hetero_plan").solution(0)
