"""Self-contained dense linear-programming solver (two-phase primal simplex).

The container ships without scipy, and the paper's planning problems (Eqs. 40,
42, 49) are small (a handful of classes -> tens of variables/constraints), so a
carefully written dense tableau simplex with Bland anti-cycling is exact enough
and fully controllable.  We also return dual variables so the SLI benchmarks can
report *shadow prices* (Section 6.3) directly from the solver.

Problem form::

    maximize    c' x
    subject to  A_ub x <= b_ub
                A_eq x == b_eq
                x >= 0
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["LPResult", "linprog_max", "LPInfeasible", "LPUnbounded"]


class LPInfeasible(RuntimeError):
    pass


class LPUnbounded(RuntimeError):
    pass


@dataclass
class LPResult:
    x: np.ndarray  # primal solution (original variables)
    fun: float  # optimal objective value (of the maximisation)
    slack: np.ndarray  # slacks of the <= rows
    dual_ub: np.ndarray  # duals of <= rows (>= 0)
    dual_eq: np.ndarray  # duals of == rows (free sign)
    n_iter: int = 0
    status: str = "optimal"
    basis: list = field(default_factory=list)


def _pivot(T: np.ndarray, basis: np.ndarray, row: int, col: int) -> None:
    T[row] /= T[row, col]
    piv = T[:, col].copy()
    piv[row] = 0.0
    T -= np.outer(piv, T[row])
    basis[row] = col


def _simplex(T: np.ndarray, basis: np.ndarray, n_total: int, tol: float,
             max_iter: int, bland_after: Optional[int] = None) -> int:
    """Run primal simplex on tableau T (last row = -reduced costs for max).

    Uses Dantzig rule with a Bland fallback to guarantee termination: the
    fallback engages after a run of degenerate (zero-progress) pivots,
    and unconditionally once the *total* pivot count passes
    ``bland_after`` (default ``10 * (m + n_total)``) -- Dantzig can cycle
    through degenerate bases without ever stalling on one of them, so a
    stall counter alone is not a termination proof; Bland's rule is.
    Returns the iteration count.
    """
    m = T.shape[0] - 1
    if bland_after is None:
        bland_after = 10 * (m + n_total)
    it = 0
    stall = 0
    while it < max_iter:
        it += 1
        red = T[-1, :n_total]
        use_bland = stall > 2 * (m + n_total) or it > bland_after
        if use_bland:
            cand = np.nonzero(red < -tol)[0]
            if cand.size == 0:
                return it
            col = int(cand[0])
        else:
            col = int(np.argmin(red))
            if red[col] >= -tol:
                return it
        ratios = np.full(m, np.inf)
        pos = T[:m, col] > tol
        ratios[pos] = T[:m, -1][pos] / T[:m, col][pos]
        row = int(np.argmin(ratios))
        if not np.isfinite(ratios[row]):
            raise LPUnbounded("LP is unbounded")
        if use_bland:
            best = ratios[row]
            tie = np.nonzero(np.abs(ratios - best) <= tol * (1 + abs(best)))[0]
            row = int(tie[np.argmin(basis[tie])])
        if ratios[row] <= tol:
            stall += 1
        else:
            stall = 0
        _pivot(T, basis, row, col)
    raise RuntimeError("simplex iteration limit exceeded")


def linprog_max(
    c: np.ndarray,
    A_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    A_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
    tol: float = 1e-9,
    max_iter: int = 20000,
    bland_after: Optional[int] = None,
) -> LPResult:
    """Solve ``max c'x s.t. A_ub x <= b_ub, A_eq x == b_eq, x >= 0``.

    ``bland_after`` caps the number of Dantzig pivots before each phase
    permanently switches to Bland's rule (anti-cycling safety valve);
    ``None`` picks ``10 * (rows + columns)``.
    """
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    if A_ub is None:
        A_ub = np.zeros((0, n))
        b_ub = np.zeros(0)
    if A_eq is None:
        A_eq = np.zeros((0, n))
        b_eq = np.zeros(0)
    A_ub = np.atleast_2d(np.asarray(A_ub, dtype=np.float64))
    A_eq = np.atleast_2d(np.asarray(A_eq, dtype=np.float64))
    b_ub = np.asarray(b_ub, dtype=np.float64).ravel()
    b_eq = np.asarray(b_eq, dtype=np.float64).ravel()
    m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
    m = m_ub + m_eq

    # Standard form: [A_ub | I_slack ; A_eq | 0] x_aug = b, x_aug >= 0.
    A = np.zeros((m, n + m_ub))
    A[:m_ub, :n] = A_ub
    A[:m_ub, n:] = np.eye(m_ub)
    A[m_ub:, :n] = A_eq
    b = np.concatenate([b_ub, b_eq])
    # Make b >= 0 (flip rows).
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0

    n_sn = n + m_ub  # structural + slack count

    # ---- Phase 1: artificial variables on every row -----------------------
    T = np.zeros((m + 1, n_sn + m + 1))
    T[:m, :n_sn] = A
    T[:m, n_sn : n_sn + m] = np.eye(m)
    T[:m, -1] = b
    # Phase-1 objective: minimise sum of artificials == maximise -sum(a).
    T[-1, n_sn : n_sn + m] = 1.0
    # Price out the artificial basis.
    T[-1, :] -= T[:m, :].sum(axis=0)
    basis = np.arange(n_sn, n_sn + m)
    it1 = _simplex(T, basis, n_sn + m, tol, max_iter, bland_after)
    phase1 = -T[-1, -1]
    if phase1 > 1e-7 * max(1.0, np.abs(b).max()):
        raise LPInfeasible(f"phase-1 infeasibility residual {phase1:.3e}")

    # Drive any artificial still in the basis out (degenerate rows).
    for r in range(m):
        if basis[r] >= n_sn:
            cols = np.nonzero(np.abs(T[r, :n_sn]) > tol)[0]
            if cols.size:
                _pivot(T, basis, r, int(cols[0]))
            # else: redundant row, leave the zero artificial basic.

    # ---- Phase 2 -----------------------------------------------------------
    T2 = np.zeros((m + 1, n_sn + 1))
    T2[:m, :n_sn] = T[:m, :n_sn]
    T2[:m, -1] = T[:m, -1]
    c_aug = np.zeros(n_sn)
    c_aug[:n] = c
    T2[-1, :n_sn] = -c_aug
    # Price out the current basis.
    for r in range(m):
        if basis[r] < n_sn and abs(T2[-1, basis[r]]) > 0:
            T2[-1, :] -= T2[-1, basis[r]] * T2[r, :]
    # Forbid re-entry of artificials by construction (they're not in T2).
    basis2 = basis.copy()
    it2 = _simplex(T2, basis2, n_sn, tol, max_iter, bland_after)

    x_aug = np.zeros(n_sn)
    for r in range(m):
        if basis2[r] < n_sn:
            x_aug[basis2[r]] = T2[r, -1]
    x = x_aug[:n]
    fun = float(c @ x)

    # Duals: solve y' B = c_B' from the final basis (artificial leftovers from
    # redundant rows contribute unit columns e_r with zero cost).
    B_cols = [int(j) for j in basis2]
    Bmat = np.zeros((m, m))
    cB = np.zeros(m)
    for k, j in enumerate(B_cols):
        if j < n_sn:
            Bmat[:, k] = A[:, j]
            cB[k] = c_aug[j]
        else:
            Bmat[j - n_sn, k] = 1.0  # artificial column e_{j-n_sn}
    try:
        y = np.linalg.solve(Bmat.T, cB)
    except np.linalg.LinAlgError:
        y, *_ = np.linalg.lstsq(Bmat.T, cB, rcond=None)
    # Undo the row sign flips applied to make b >= 0.
    y = np.where(neg, -y, y)
    dual_eq = y[m_ub:].copy()
    dual_ub = np.maximum(y[:m_ub], 0.0)

    slack = b_ub - A_ub @ x if m_ub else np.zeros(0)
    return LPResult(
        x=x,
        fun=fun,
        slack=slack,
        dual_ub=dual_ub,
        dual_eq=dual_eq,
        n_iter=it1 + it2,
        basis=B_cols,
    )
