"""Batched fluid-trajectory evaluation for sweep grids.

The fluid ODE (Section 3) is deterministic and per-server scale, so a
sweep's whole (mix x policy) plane can be integrated as ONE batched
Euler loop instead of a Python loop of integrations: every instance's
parameter tensors (:func:`repro_torch.core.fluid.fluid_params`) are
stacked along a new leading axis, which the port's Euler step
broadcasts over, and :func:`repro_torch.core.fluid.fluid_final_state`
runs once per router family (the solo-first / randomized branch is a
Python flag of the loop).  The reference's ``repro.sweep.fluid_batch``
does the same with ``jax.vmap``.  On the card the loop replays CUDA
graphs of Euler steps (:mod:`repro_torch.core.fluid`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.fluid import fluid_final_state, fluid_params

from .evaluators import MixContext, parse_policy_token

__all__ = ["fluid_policy_plan", "integrate_fluid_batch",
           "evaluate_fluid_grid"]

# policy token -> (plan kind, randomized-router flag)
_FLUID_POLICIES = {
    "gate_and_route": ("base", False),
    "sli_aware": ("sli", True),
}


def fluid_policy_plan(token: str):
    name, _ = parse_policy_token(token)
    if name not in _FLUID_POLICIES:
        raise ValueError(
            f"fluid evaluator supports {sorted(_FLUID_POLICIES)}, "
            f"got {token!r}")
    return _FLUID_POLICIES[name]


def integrate_fluid_batch(params_list: Sequence[dict], dt: float,
                          n_steps: int, randomized: bool) -> tuple:
    """Integrate a batch of fluid instances to steady state in one
    batched Euler loop.

    All instances must share the class count I, dtype and device
    (leaves stack to (S, I)).  Returns ``(final_state, revenue_rate)``
    with a leading batch axis: ``final_state`` is the ``(qp, x, qdm,
    qds, ym, ys)`` tuple of (S, I) tensors, ``revenue_rate`` is (S,).
    Only the final step is kept, so memory stays O(S * I) regardless of
    n_steps.
    """
    batched = {k: torch.stack([p[k] for p in params_list])
               for k in params_list[0]}
    z = torch.zeros_like(batched["lam"])
    return fluid_final_state(batched, (z, z, z, z, z, z), dt,
                             n_steps=n_steps, randomized=randomized)


def evaluate_fluid_grid(contexts: Sequence[MixContext],
                        policies: Sequence[str], horizon: float,
                        dt: float) -> dict:
    """Metrics for every (mix, policy) pair, batched per router family,
    in float32 (as the reference runs without ``x64``) on the contexts'
    device.

    Returns ``{(mix_index, policy_index): metrics dict}``.  The fluid
    limit has no cluster-size or seed dependence; the sweep runner
    replicates these metrics across the degenerate (n, seed) axes.
    """
    n_steps = max(1, int(horizon / dt))
    jobs: dict = {}  # randomized flag -> list of (key, params, plan)
    for mi, ctx in enumerate(contexts):
        for pi, token in enumerate(policies):
            kind, randomized = fluid_policy_plan(token)
            plan = ctx.plan(kind)
            params = fluid_params(ctx.classes, ctx.prim, ctx.pricing, plan,
                                  randomized_router=randomized,
                                  device=ctx.device)
            jobs.setdefault(randomized, []).append(((mi, pi), params, plan))

    out: dict = {}
    for randomized, group in jobs.items():
        keys = [g[0] for g in group]
        params_list = [g[1] for g in group]
        plans = [g[2] for g in group]
        state, rev = integrate_fluid_batch(params_list, dt, n_steps,
                                           randomized)
        qp, x, qdm, qds, ym, ys = (v.cpu().numpy() for v in state)
        rev = rev.cpu().numpy()
        qd = qdm + qds
        for b, key in enumerate(keys):
            plan = plans[b]
            m = {
                "revenue_rate": float(rev[b]),
                "R_star": float(plan.revenue_rate),
            }
            if plan.revenue_rate > 0:
                m["gap_pct"] = 100.0 * (1.0 - m["revenue_rate"]
                                        / m["R_star"])
            fx = x[b]
            fy = ym[b] + ys[b]
            y_star = plan.ym + plan.ys
            for i in range(fx.shape[0]):
                m[f"avg_x/{i}"] = float(fx[i])
                m[f"avg_y/{i}"] = float(fy[i])
                m[f"avg_qp/{i}"] = float(qp[b, i])
                m[f"avg_qd/{i}"] = float(qd[b, i])
                m[f"x_star/{i}"] = float(plan.x[i])
                m[f"y_star/{i}"] = float(y_star[i])
            m["x_err_l1"] = float(np.abs(fx - plan.x).sum())
            m["y_err_l1"] = float(np.abs(fy - y_star).sum())
            out[key] = m
    return out
