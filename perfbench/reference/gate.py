"""Plain reference of the admission layer: the bundled-charging planning
LP (the paper's Eq. 40) solved again with SciPy, and the occupancy gate's
rule (Section 4.1) applied to each admission the run recorded.

LP, per class i, in units of one server: maximise
sum_i w_i (mu_m,i ym_i + mu_s,i ys_i) subject to
sum x <= 1,  sum ym <= (B - 1) sum x,  sum ys + B sum x <= B,
mu_p,i x_i + theta_i qp_i = lambda_i,
mu_p,i x_i = theta_i qd_i + mu_m,i ym_i + mu_s,i ys_i,  all >= 0,
with tau = alpha + beta C, mu_p = C / (P tau), mu_m = 1 / (D tau),
mu_s = gamma / D and w = c_p P + c_d D.

Gate: admit the waiting class with the least (X_i + 1 - n x_i*) / x_i*,
ties to the largest Q_i - n qp_i*; a class with x_i* = 0 is never
admitted. Here n = 1.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog

__all__ = ["solve_plan", "gate_choice", "check_admissions"]


def solve_plan(classes, prim: dict, c_p: float, c_d: float):
    """classes: [(P, D, lambda, theta)]; prim: alpha, beta, gamma,
    batch_cap, chunk. Returns (x, qp, revenue rate)."""
    I = len(classes)
    P, D, lam, th = (np.array(v, float) for v in zip(*classes))
    B, C = float(prim["batch_cap"]), float(prim["chunk"])
    tau = prim["alpha"] + prim["beta"] * C
    mu_p, mu_m, mu_s = C / (P * tau), 1.0 / (D * tau), prim["gamma"] / D
    w = c_p * P + c_d * D
    z = np.zeros(I)
    one = np.ones(I)
    eye = np.eye(I)
    # columns: x, ym, ys, qp, qd
    cost = -np.concatenate([z, w * mu_m, w * mu_s, z, z])
    A_ub = np.array([np.concatenate([one, z, z, z, z]),
                     np.concatenate([-(B - 1) * one, one, z, z, z]),
                     np.concatenate([B * one, z, one, z, z])])
    b_ub = np.array([1.0, 0.0, B])
    A_eq = np.vstack([
        np.hstack([eye * mu_p, 0 * eye, 0 * eye, eye * th, 0 * eye]),
        np.hstack([eye * mu_p, -eye * mu_m, -eye * mu_s, 0 * eye,
                   -eye * th])])
    b_eq = np.concatenate([lam, z])
    res = linprog(cost, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=(0, None), method="highs")
    if res.status != 0:
        raise ValueError(f"reference LP: {res.message}")
    return res.x[:I], res.x[3 * I:4 * I], float(-res.fun)


def gate_choice(x, qp, waiting, qlen, X, n: int = 1):
    best, key = None, None
    for i in waiting:
        if x[i] <= 1e-12:
            continue
        k = ((X[i] + 1.0 - n * x[i]) / x[i], -(qlen[i] - n * qp[i]))
        if key is None or k < key:
            best, key = i, k
    return best


def check_admissions(admissions, x, qp) -> int:
    """How many recorded admissions (waiting, qlen, X, chosen) the rule
    over the reference's plan would have made otherwise."""
    return sum(gate_choice(x, qp, w, q, X) != i
               for w, q, X, i in admissions)
