"""Fixed-iteration batched LP solver (primal-dual interior point, torch).

The planning layer (Eqs. 40/42 + SLI rows) needs many small dense LP
solves per sweep or replan epoch; the tableau simplex in
:mod:`repro_torch.core.lp` is exact but serial Python.  This module solves
the same problem form

    maximize    c' x
    subject to  A_ub x <= b_ub
                A_eq x == b_eq
                x >= 0

with a **Mehrotra predictor-corrector interior-point method** whose every
step is a fixed-shape dense linear solve, so a whole batch of instances
runs as one tensor program over the leading axis, with
:func:`repro_torch.core.lp.linprog_max` kept as the semantics oracle.  The
module keeps the reference's name (``repro.core.lp_jax``).

Why interior point (and not a batched simplex): the simplex's pivot
sequence is data-dependent control flow (ragged across a batch), while the
IPM is a *fixed iteration count* of identical Newton steps on the
standard-form KKT system.  The ``DEFAULT_ITERS = 60`` steps run as a host
loop over batched tensors with no read back to the host inside it;
iterates freeze once converged (steps are masked), so extra budget costs
FLOPs, not accuracy.

Numerics: everything runs in float64 (the normal equations square the
condition number).  The standard-form data is Ruiz-equilibrated before
iterating, the start is the least-squares point shifted positive
(Cholesky on the regularised ``A A'``), and each Newton step solves the
regularised augmented KKT system by LU.  Where the reference's Cholesky
returns NaNs (a matrix that is not positive definite), the port's does
too, so the ``converged`` flags agree.

Infeasible/unbounded instances do not raise here; they surface as
``converged == False`` with large final residuals in the
:class:`LPBatchResult` diagnostics.  Callers that need hard errors (the
planner) check ``converged``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.compat import resolve_device

__all__ = ["LPBatchResult", "solve_lp_batch", "linprog_max_jax",
           "DEFAULT_ITERS", "DEFAULT_TOL"]

DEFAULT_ITERS = 60  # fixed Newton-step budget (see module docstring)
DEFAULT_TOL = 1e-9  # relative primal/dual/complementarity target
_ETA = 0.99  # fraction-to-boundary step damping
_FLOOR = 1e-300  # positivity floor for (z, s) after a step
_RUIZ_ITERS = 6
_F64 = torch.float64


@dataclass
class LPBatchResult:
    """Batched solver output; every leaf has leading batch axis S.

    ``primal_res`` / ``dual_res`` / ``gap`` are the final *relative*
    residuals (infinity norms over ``1 + |data|``; ``gap`` is the mean
    complementarity over ``1 + |objective|``); ``converged`` is their
    joint ``< tol`` test and ``n_iter`` counts Newton steps actually
    taken before the iterate froze.
    """

    x: np.ndarray  # (S, n) primal solution (original variables)
    fun: np.ndarray  # (S,) objective value c'x of the maximisation
    slack: np.ndarray  # (S, m_ub) slacks of the <= rows
    dual_ub: np.ndarray  # (S, m_ub) duals of <= rows (>= 0)
    dual_eq: np.ndarray  # (S, m_eq) duals of == rows (free sign)
    primal_res: np.ndarray  # (S,)
    dual_res: np.ndarray  # (S,)
    gap: np.ndarray  # (S,)
    converged: np.ndarray  # (S,) bool
    n_iter: np.ndarray  # (S,) int


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _max_step(v, dv):
    """Largest alpha in [0, 1] keeping v + alpha * dv >= 0 (per row)."""
    neg = dv < 0
    ratios = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(torch.amin(ratios, -1), max=1.0)


def _amax_abs(v):
    return torch.amax(v.abs(), -1)


def _ruiz(Ah, bh, ch):
    """Ruiz equilibration of the standard-form data + scalar b/c scaling."""
    S, m, nh = Ah.shape
    Dr = torch.ones((S, m), dtype=_F64, device=Ah.device)
    Dc = torch.ones((S, nh), dtype=_F64, device=Ah.device)
    for _ in range(_RUIZ_ITERS):
        rn = torch.amax(Ah.abs(), 2)
        rs = torch.where(rn > 0, 1.0 / torch.sqrt(rn), 1.0)
        Ah = Ah * rs[:, :, None]
        cn = torch.amax(Ah.abs(), 1)
        cs = torch.where(cn > 0, 1.0 / torch.sqrt(cn), 1.0)
        Ah = Ah * cs[:, None, :]
        Dr, Dc = Dr * rs, Dc * cs
    bs = bh * Dr
    cs = ch * Dc
    beta = torch.clamp(_amax_abs(bs), min=1.0)
    gamma = torch.clamp(_amax_abs(cs), min=1.0)
    return Ah, bs / beta[:, None], cs / gamma[:, None], Dr, Dc, beta, gamma


def _ipm(c, A_ub, b_ub, A_eq, b_eq, tol: float, iters: int) -> dict:
    """A batch of instances: max c'x, A_ub x <= b_ub, A_eq x == b_eq,
    x >= 0 (float64 tensors with a leading batch axis)."""
    S, n = c.shape
    m_ub, m_eq = A_ub.shape[1], A_eq.shape[1]
    m = m_ub + m_eq
    nh = n + m_ub
    dev = c.device
    eye_ub = torch.eye(m_ub, dtype=_F64, device=dev)
    eye_m = torch.eye(m, dtype=_F64, device=dev)

    # Standard equality form over z = [x; w]:  Ah z = bh, z >= 0, and the
    # *minimisation* objective ch = -[c; 0] (duals are negated back below).
    Ah = torch.zeros((S, m, nh), dtype=_F64, device=dev)
    Ah[:, :m_ub, :n] = A_ub
    Ah[:, :m_ub, n:] = eye_ub
    Ah[:, m_ub:, :n] = A_eq
    bh = torch.cat([b_ub, b_eq], 1)
    ch = torch.cat([-c, torch.zeros((S, m_ub), dtype=_F64, device=dev)], 1)
    AhT = Ah.transpose(1, 2)

    As, bs, cs, Dr, Dc, beta, gamma = _ruiz(Ah, bh, ch)
    AsT = As.transpose(1, 2)
    delta = 1e-12  # static primal-dual regularisation of the normal matrix

    # Mehrotra starting point: least-squares (z, y, s) shifted positive.
    AAt = As @ AsT
    tr = torch.diagonal(AAt, dim1=1, dim2=2).sum(1)
    AAt = AAt + (delta * (1.0 + tr / m))[:, None, None] * eye_m
    L0, info = torch.linalg.cholesky_ex(AAt)
    # the reference's Cholesky gives NaNs off the positive-definite cone
    L0 = torch.where((info != 0)[:, None, None], torch.nan, L0)
    z_ls = _mv(AsT, torch.cholesky_solve(bs[..., None], L0)[..., 0])
    y0 = torch.cholesky_solve(_mv(As, cs)[..., None], L0)[..., 0]
    s_ls = cs - _mv(AsT, y0)

    def shift(v):
        return v + torch.clamp(-1.5 * torch.amin(v, 1), min=0.0)[:, None] \
            + 1e-2

    z_sh, s_sh = shift(z_ls), shift(s_ls)
    dot = (z_sh * s_sh).sum(1)
    z = z_sh + (0.5 * dot / s_sh.sum(1))[:, None]
    s = s_sh + (0.5 * dot / z_sh.sum(1))[:, None]
    y = y0

    bh_scale = 1.0 + _amax_abs(bh)
    ch_scale = 1.0 + _amax_abs(ch)

    def residuals(z, y, s):
        """Relative residuals on the ORIGINAL (unscaled, max-form) data."""
        z_f = Dc * beta[:, None] * z
        s_f = (gamma[:, None] / Dc) * s
        y_f = Dr * gamma[:, None] * y
        pr = _amax_abs(bh - _mv(Ah, z_f)) / bh_scale
        dr = _amax_abs(ch - _mv(AhT, y_f) - s_f) / ch_scale
        gp = ((z_f * s_f).sum(1) / nh) / (1.0 + (ch * z_f).sum(1).abs())
        return pr, dr, gp

    reg = 1e-10  # primal-dual regularisation of the augmented system
    K = torch.zeros((S, nh + m, nh + m), dtype=_F64, device=dev)
    K[:, :nh, nh:] = AsT
    K[:, nh:, :nh] = As
    K[:, nh:, nh:] = reg * eye_m
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    it = torch.zeros(S, dtype=torch.int32, device=dev)
    for _ in range(iters):
        r_p = bs - _mv(As, z)
        r_d = cs - _mv(AsT, y) - s
        mu = (z * s).sum(1) / nh
        pr, dr, gp = residuals(z, y, s)
        done = done | ((pr < tol) & (dr < tol) & (gp < tol))

        # Regularised augmented KKT system (quasi-definite; LU-solved).
        # Normal equations A D A' square the conditioning and break down
        # on degenerate optimal faces (d = z/s spans ~1e16 there); the
        # augmented form stays solvable to float64 accuracy.
        K[:, :nh, :nh] = torch.diag_embed(-s / z - reg)
        LU, piv, _ = torch.linalg.lu_factor_ex(K)

        def direction(tau):
            rhs = torch.cat([r_d - (tau - z * s) / z, r_p], 1)
            sol = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
            dz, dy = sol[:, :nh], sol[:, nh:]
            ds = (tau - z * s - s * dz) / z
            return dz, dy, ds

        # Mehrotra: affine predictor -> centring parameter -> corrector.
        dz_a, dy_a, ds_a = direction(torch.zeros_like(z))
        a_p = _max_step(z, dz_a)
        a_d = _max_step(s, ds_a)
        mu_aff = ((z + a_p[:, None] * dz_a) * (s + a_d[:, None] * ds_a)
                  ).sum(1) / nh
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=_FLOOR)) ** 3,
                            0.0, 1.0)
        dz, dy, ds = direction((sigma * mu)[:, None] - dz_a * ds_a)
        a_p = torch.clamp(_ETA * _max_step(z, dz), max=1.0)[:, None]
        a_d = torch.clamp(_ETA * _max_step(s, ds), max=1.0)[:, None]

        # Frozen-once-converged: where (not arithmetic masking) so a
        # post-convergence NaN direction can never leak into the iterate.
        keep = done[:, None]
        z = torch.where(keep, z, torch.clamp(z + a_p * dz, min=_FLOOR))
        s = torch.where(keep, s, torch.clamp(s + a_d * ds, min=_FLOOR))
        y = torch.where(keep, y, y + a_d * dy)
        it = it + (~done).to(torch.int32)

    # Undo the scaling; final diagnostics on the ORIGINAL (max-form) data.
    z_full = Dc * beta[:, None] * z
    y_max = -(Dr * gamma[:, None] * y)
    x = z_full[:, :n]
    pr, dr, gp = residuals(z, y, s)
    return {
        "x": x,
        "fun": (c * x).sum(1),
        "slack": z_full[:, n:],
        "dual_ub": torch.clamp(y_max[:, :m_ub], min=0.0),
        "dual_eq": y_max[:, m_ub:],
        "primal_res": pr,
        "dual_res": dr,
        "gap": gp,
        "converged": (pr < tol) & (dr < tol) & (gp < tol),
        "n_iter": it,
    }


def _as_batch(a, shape, name):
    out = np.asarray(a, dtype=np.float64)
    if out.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {out.shape}")
    return out


def solve_lp_batch(
    c: np.ndarray,
    A_ub: np.ndarray = None,
    b_ub: np.ndarray = None,
    A_eq: np.ndarray = None,
    b_eq: np.ndarray = None,
    *,
    iters: int = DEFAULT_ITERS,
    tol: float = DEFAULT_TOL,
    device=None,
) -> LPBatchResult:
    """Solve a batch of ``max c'x s.t. A_ub x <= b_ub, A_eq x == b_eq,
    x >= 0`` instances in one batched interior-point run on ``device``
    (the card by default).

    ``c`` is (S, n); constraint blocks are (S, m, n) / (S, m) with the
    same (m, n) across the batch (pad degenerate instances; values may
    vary freely).  ``None`` blocks mean zero rows.  Returns a
    :class:`LPBatchResult` of host numpy arrays.
    """
    dev = resolve_device(device)
    c = np.atleast_2d(np.asarray(c, dtype=np.float64))
    S, n = c.shape
    if A_ub is None:
        A_ub = np.zeros((S, 0, n))
        b_ub = np.zeros((S, 0))
    if A_eq is None:
        A_eq = np.zeros((S, 0, n))
        b_eq = np.zeros((S, 0))
    A_ub = np.asarray(A_ub, dtype=np.float64)
    m_ub = A_ub.shape[1]
    m_eq = np.asarray(A_eq).shape[1]
    A_ub = _as_batch(A_ub, (S, m_ub, n), "A_ub")
    b_ub = _as_batch(b_ub, (S, m_ub), "b_ub")
    A_eq = _as_batch(A_eq, (S, m_eq, n), "A_eq")
    b_eq = _as_batch(b_eq, (S, m_eq), "b_eq")

    def t(a):
        return torch.as_tensor(a, dtype=_F64).to(dev)

    out = _ipm(t(c), t(A_ub), t(b_ub), t(A_eq), t(b_eq), float(tol),
               int(iters))
    return LPBatchResult(**{k: v.cpu().numpy() for k, v in out.items()})


def linprog_max_jax(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, *,
                    iters: int = DEFAULT_ITERS,
                    tol: float = DEFAULT_TOL, device=None) -> LPBatchResult:
    """Single-instance convenience wrapper (batch axis of 1, squeezed).

    Same problem form and result fields as
    :func:`repro_torch.core.lp.linprog_max`; use the oracle when you need
    exact vertex solutions or a basis, use this when you need the
    fixed-iteration batched path.
    """
    c = np.asarray(c, dtype=np.float64)

    def up(a, rows=False):
        if a is None:
            return None
        a = np.asarray(a, dtype=np.float64)
        return a[None] if rows else np.atleast_2d(a)[None]

    res = solve_lp_batch(c[None], up(A_ub), up(b_ub, rows=True),
                         up(A_eq), up(b_eq, rows=True),
                         iters=iters, tol=tol, device=device)
    return LPBatchResult(**{k: v[0] for k, v in res.__dict__.items()})
