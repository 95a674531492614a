"""Fluid model of Section 3, integrated by explicit Euler steps.

Integrates the fluid dynamics (24)-(32) under the gate-and-route policy
family (instantaneous occupancy-tracking prefill gate + work-conserving
solo-first or randomized decode router), and exposes the steady state for
validation against the planning LP (Theorem 2 / Theorem 4) and against
the CTMC simulators (Theorem 1).

The integrator is split into :func:`fluid_params` (per-instance parameter
tensors) and :func:`integrate_fluid_core` (the Euler loop over them), as
in the reference (``repro.core.fluid``, whose loop is a ``lax.scan``).
Here the loop runs over tensors on ``device`` (the card by default), in
the ``dtype`` the caller passes (float32 by default, as the reference
runs without ``x64``): eagerly on the CPU, and on the card as replays of
a CUDA graph of K steps between record points, bit for bit the eager
loop.  Tensors may carry leading batch axes: every per-class sum is
over the last axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device

from .planning import PlanSolution
from .types import (Pricing, ServicePrimitives, WorkloadClass, rate_arrays,
                    resolve_primitives)

__all__ = [
    "FluidTrajectory",
    "fluid_params",
    "integrate_fluid_core",
    "fluid_final_state",
    "integrate_fluid",
    "fluid_steady_state",
]


@dataclass
class FluidTrajectory:
    t: np.ndarray
    qp: np.ndarray  # (T, I)
    x: np.ndarray
    qd: np.ndarray
    ym: np.ndarray
    ys: np.ndarray
    revenue_rate: np.ndarray  # (T,) instantaneous bundled reward rate

    def final(self) -> dict:
        return {
            "qp": self.qp[-1],
            "x": self.x[-1],
            "qd": self.qd[-1],
            "ym": self.ym[-1],
            "ys": self.ys[-1],
        }


def fluid_params(
    classes: Sequence[WorkloadClass],
    prim: ServicePrimitives,
    pricing: Pricing,
    plan: PlanSolution,
    randomized_router: bool = False,
    *,
    dtype=torch.float32,
    device=None,
) -> dict:
    """Parameter tensors of the fluid ODE for one problem instance, in
    ``dtype`` on ``device`` (``p_s`` is all-ones when the solo-first router
    is in force; the branch itself is selected by the ``randomized`` flag
    of :func:`integrate_fluid_core`)."""
    dev = resolve_device(device)
    prim = resolve_primitives(prim)
    arr = rate_arrays(classes, prim)
    B = float(prim.batch_cap)

    def a(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               dtype=dtype).to(dev)

    x_star = a(plan.x)
    X_star = torch.sum(x_star)  # static partition: fraction of mixed servers
    p_s = (a(plan.solo_probs()) if randomized_router
           else torch.ones_like(x_star))
    return {
        "lam": a(arr["lam"]),
        "theta": a(arr["theta"]),
        "mu_p": a(arr["mu_p"]),
        "mu_m": a(arr["mu_m"]),
        "mu_s": a(arr["mu_s"]),
        "w": a([pricing.bundled_reward(c) for c in classes]),
        "x_star": x_star,
        "cap_m": (B - 1.0) * X_star,
        "cap_s": B * (1.0 - X_star),
        "p_s": p_s,
        "p_m": 1.0 - p_s,
    }


def _frac(tot, free):
    """The share of a buffer of total ``tot`` that ``free`` slots take
    (FCFS-equivalent proportional fill): ``min(tot, free) / max(tot,
    1e-30)``, 0 where ``tot == 0`` as in the reference."""
    return torch.minimum(tot, free) / torch.clamp_min(tot, 1e-30)


def _free(cap, y):
    return torch.clamp_min(cap - y.sum(-1, keepdim=True), 0.0)


def _fluid_step(params: dict, S, kdt, adt, randomized: bool):
    """One Euler step of the policy fluid on the stacked state
    ``S = [qp, x, qdm, qds, ym, ys]`` (..., 6, I).

    The reference's step (``repro.core.fluid._fluid_step``) in fewer tensor
    operations: the flows in one product (``kdt`` = dt x [theta, mu_p,
    theta, theta, mu_m, mu_s], ``adt`` = [lam dt, 0, ...]), and each
    buffer drain as one fraction of the pooled buffer (the reference
    divides each class's pull by its own buffer, which gives the same
    fraction).  Only roundings differ from the reference, a few ULPs a
    step; the tests hold the trajectories to 1e-10 in float64."""
    x_star = params["x_star"]
    cap_m = params["cap_m"][..., None]
    cap_s = params["cap_s"][..., None]
    # -- primitive flows over dt ------------------------------------------
    F = S * kdt
    qp, x, qdm, qds, ym, ys = (S - F + adt).unbind(-2)
    sp = F[..., 1, :]

    # -- prefill gate: instantaneous pull-up to targets --------------------
    admit = torch.minimum(qp, torch.clamp_min(x_star - x, 0.0))
    x = x + admit
    qp = qp - admit

    # -- decode router ------------------------------------------------------
    if not randomized:
        # solo-first, single logical buffer (kept in the solo half)
        to_s = sp * _frac(sp.sum(-1, keepdim=True), _free(cap_s, ys))
        ys = ys + to_s
        inflow = sp - to_s
        to_m = inflow * _frac(inflow.sum(-1, keepdim=True),
                              _free(cap_m, ym))
        ym = ym + to_m
        qd = torch.stack((qdm, qds + (inflow - to_m)), -2)
        # work-conserving buffer drain (solo first), both halves alike
        qtot = qd.sum(-2)
        f = _frac(qtot.sum(-1, keepdim=True), _free(cap_s, ys))
        ys = ys + qtot * f
        qd = qd - qd * f[..., None]
        qtot = qd.sum(-2)
        f = _frac(qtot.sum(-1, keepdim=True), _free(cap_m, ym))
        ym = ym + qtot * f
        qd = torch.clamp_min(qd - qd * f[..., None], 0.0)
        qdm, qds = qd.unbind(-2)
    else:
        # randomized router with per-pool buffers (Section 5.2 / EC.7)
        qds = qds + sp * params["p_s"]
        qdm = qdm + sp * params["p_m"]
        to_s = qds * _frac(qds.sum(-1, keepdim=True), _free(cap_s, ys))
        ys = ys + to_s
        qds = torch.clamp_min(qds - to_s, 0.0)
        to_m = qdm * _frac(qdm.sum(-1, keepdim=True), _free(cap_m, ym))
        ym = ym + to_m
        qdm = torch.clamp_min(qdm - to_m, 0.0)

    return torch.stack((torch.clamp_min(qp, 0.0), x, qdm, qds, ym, ys), -2)


def _revenue_rate(params: dict, ym, ys):
    """Instantaneous bundled reward rate of a fluid state (Eq. 21 flow)."""
    return torch.sum(params["w"] * (params["mu_m"] * ym
                                    + params["mu_s"] * ys), -1)


#: Euler steps a CUDA graph holds at most (see :func:`_graph_steps`)
GRAPH_STEPS = 256


def _graph_steps(span: int) -> int:
    """Steps one graph holds for runs of ``span`` steps between record
    points: the largest divisor of ``span`` up to :data:`GRAPH_STEPS`
    when it is at least a quarter of that, else :data:`GRAPH_STEPS`
    (the remainder of each run then goes eagerly)."""
    for k in range(min(span, GRAPH_STEPS), GRAPH_STEPS // 4 - 1, -1):
        if span % k == 0:
            return k
    return GRAPH_STEPS


def _capture(params: dict, S, kdt, adt, randomized: bool, k: int):
    """A CUDA graph of ``k`` Euler steps on a static state buffer: each
    replay advances ``buf`` by ``k`` steps in place, through the same
    kernels, in the same order, as ``k`` eager steps."""
    buf = S.clone()
    side = torch.cuda.Stream(device=buf.device)
    side.wait_stream(torch.cuda.current_stream(buf.device))
    with torch.cuda.stream(side):
        # one eager step first: lazy set-up must not happen in the capture
        _fluid_step(params, buf.clone(), kdt, adt, randomized)
    torch.cuda.current_stream(buf.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = buf
        for _ in range(k):
            x = _fluid_step(params, x, kdt, adt, randomized)
        buf.copy_(x)
    return graph, buf


def _integrate(params: dict, state0: tuple, dt, n_steps: int,
               randomized: bool, record: Sequence[int],
               graphed: Optional[bool] = None):
    """The Euler loop; stacks ``(qp, x, qd, ym, ys, revenue_rate)`` of the
    steps in ``record`` (ascending), and returns them with the last
    state tuple.

    On the card (``graphed`` defaults to whether the state lies on a
    CUDA device) the loop replays a CUDA graph of K Euler steps
    (:func:`_graph_steps`) between record points and runs each run's
    remainder eagerly: the same kernels in the same order as the eager
    loop, so the result is bit for bit the eager one, at one graph
    launch per K steps instead of about 60 kernel launches a step.  On
    the CPU the loop is eager."""
    z = torch.zeros_like(params["lam"])
    kdt = torch.stack([params[k] for k in ("theta", "mu_p", "theta",
                                           "theta", "mu_m", "mu_s")],
                      -2) * dt
    adt = torch.stack([params["lam"] * dt] + [z] * 5, -2)
    rows = []
    # inference mode skips autograd's dispatch: the loop is host-bound
    with torch.inference_mode():
        S = torch.stack(tuple(state0), -2)
        if graphed is None:
            graphed = S.device.type == "cuda"
        ends = [k + 1 for k in record] + [n_steps]
        spans = [b - a for a, b in zip([0] + ends[:-1], ends)]
        graph, K = None, _graph_steps(max(spans))
        if graphed and max(spans) >= K:
            graph, buf = _capture(params, S, kdt, adt, randomized, K)
        for j, span in enumerate(spans):
            if graph is not None and span >= K:
                buf.copy_(S)
                for _ in range(span // K):
                    graph.replay()
                S = buf.clone()
                span %= K
            for _ in range(span):
                S = _fluid_step(params, S, kdt, adt, randomized)
            if j < len(record):
                rows.append(S)
        rows = torch.stack(rows) if rows else None
    out = None
    if rows is not None:
        qp, x, qdm, qds, ym, ys = rows.clone().unbind(-2)
        out = (qp, x, qdm + qds, ym, ys, _revenue_rate(params, ym, ys))
    return out, tuple(S.clone().unbind(-2))


def integrate_fluid_core(params: dict, state0: tuple, dt, *,
                         n_steps: int, randomized: bool):
    """Euler loop of the policy fluid over ``params`` / ``state0``.

    ``state0`` is the tuple ``(qp, x, qdm, qds, ym, ys)`` of per-class
    tensors; returns per-step stacked ``(qp, x, qd, ym, ys,
    revenue_rate)``.  For steady-state-only callers prefer
    :func:`fluid_final_state`, which keeps no trajectory.
    """
    out, _ = _integrate(params, state0, dt, n_steps, randomized,
                        range(n_steps))
    return out


def fluid_final_state(params: dict, state0: tuple, dt, *,
                      n_steps: int, randomized: bool):
    """Final fluid state + revenue rate only, O(1) memory in n_steps."""
    _, final = _integrate(params, state0, dt, n_steps, randomized, ())
    return final, _revenue_rate(params, final[4], final[5])


def _initial_state(I: int, x0: Optional[dict], dtype, device) -> tuple:
    z = torch.zeros(I, dtype=dtype, device=device)
    if x0 is None:
        return (z, z, z, z, z, z)
    return tuple(
        torch.as_tensor(np.asarray(x0.get(k, np.zeros(I)), dtype=np.float64),
                        dtype=dtype).to(device)
        for k in ("qp", "x", "qdm", "qds", "ym", "ys"))


def integrate_fluid(
    classes: Sequence[WorkloadClass],
    prim: ServicePrimitives,
    pricing: Pricing,
    plan: PlanSolution,
    horizon: float,
    dt: float = 1e-3,
    randomized_router: bool = False,
    x0: Optional[dict] = None,
    record_stride: int = 100,
    *,
    dtype=torch.float32,
    device=None,
) -> FluidTrajectory:
    """Euler-integrate the policy fluid; returns recorded trajectory (every
    ``record_stride``-th step, the reference's sampling)."""
    params = fluid_params(classes, prim, pricing, plan, randomized_router,
                          dtype=dtype, device=device)
    dev = params["lam"].device
    state0 = _initial_state(len(classes), x0, dtype, dev)
    n_steps = int(horizon / dt)
    idx = np.arange(0, n_steps, record_stride)
    out, _ = _integrate(params, state0, dt, n_steps, randomized_router,
                        idx.tolist())
    qp, x, qd, ym, ys, rev = (o.cpu().numpy() for o in out)
    return FluidTrajectory(
        t=(idx + 1) * dt,
        qp=qp,
        x=x,
        qd=qd,
        ym=ym,
        ys=ys,
        revenue_rate=rev,
    )


def fluid_steady_state(
    classes, prim, pricing, plan, horizon=400.0, dt=2e-3,
    randomized_router=False, *, dtype=torch.float32, device=None
) -> dict:
    traj = integrate_fluid(
        classes, prim, pricing, plan, horizon, dt,
        randomized_router=randomized_router,
        record_stride=max(1, int(horizon / dt) // 50), dtype=dtype,
        device=device,
    )
    return {
        "qp": traj.qp[-1],
        "x": traj.x[-1],
        "qd": traj.qd[-1],
        "ym": traj.ym[-1],
        "ys": traj.ys[-1],
        "revenue_rate": float(traj.revenue_rate[-1]),
    }
