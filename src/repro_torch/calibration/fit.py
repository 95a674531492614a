"""Robust affine fitting for the paper's iteration-time surfaces.

``fit_affine`` fits ``y = intercept + slope * x`` by ordinary least
squares followed by a few IRLS rounds with Huber weights, so a stray
timing outlier (a GC pause, a recompile) cannot tilt the surface.  The
degenerate constant-input case -- all ``x`` equal, or all ``y`` equal --
is reported explicitly instead of being papered over by the old
``ss_tot or 1.0`` trick in ``bench_calibration``.

No numpy dependency: the grids are tiny (tens of points) and pure-float
arithmetic keeps the fit bit-reproducible across platforms.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

__all__ = ["AffineFit", "FitDegenerateError", "fit_affine", "fit_surfaces"]

_HUBER_K = 1.345  # 95% Gaussian efficiency, the standard Huber constant
_IRLS_ROUNDS = 3


class FitDegenerateError(ValueError):
    """The inputs cannot identify an affine model (constant x)."""


@dataclass(frozen=True)
class AffineFit:
    """``y ~= intercept + slope * x`` with residual diagnostics."""

    intercept: float
    slope: float
    r2: float
    rmse: float
    max_abs_residual: float
    n: int
    constant_y: bool = False  # all y equal: slope is exactly 0 by fiat
    clamped: bool = False  # negative slope clamped to 0 (monotonicity)

    def __call__(self, x: float) -> float:
        return self.intercept + self.slope * x

    def to_dict(self) -> dict:
        return {
            "intercept": self.intercept,
            "slope": self.slope,
            "r2": self.r2,
            "rmse": self.rmse,
            "max_abs_residual": self.max_abs_residual,
            "n": self.n,
            "constant_y": self.constant_y,
            "clamped": self.clamped,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AffineFit":
        return cls(intercept=float(d["intercept"]), slope=float(d["slope"]),
                   r2=float(d["r2"]), rmse=float(d["rmse"]),
                   max_abs_residual=float(d["max_abs_residual"]),
                   n=int(d["n"]), constant_y=bool(d["constant_y"]),
                   clamped=bool(d["clamped"]))


def _wls(xs: Sequence[float], ys: Sequence[float],
         ws: Sequence[float]) -> Tuple[float, float]:
    sw = sum(ws)
    mx = sum(w * x for w, x in zip(ws, xs)) / sw
    my = sum(w * y for w, y in zip(ws, ys)) / sw
    sxx = sum(w * (x - mx) ** 2 for w, x in zip(ws, xs))
    sxy = sum(w * (x - mx) * (y - my) for w, x, y in zip(ws, xs, ys))
    slope = sxy / sxx
    return my - slope * mx, slope


def fit_affine(xs: Sequence[float], ys: Sequence[float], *,
               clamp_nonnegative_slope: bool = True) -> AffineFit:
    """Huber-robust affine fit with explicit degenerate diagnostics.

    Raises :class:`FitDegenerateError` when ``x`` carries no spread (the
    slope is unidentifiable).  A constant-``y`` input is *not* an error
    -- the surface is flat -- but the fit is flagged ``constant_y`` so
    callers can surface it instead of trusting a fabricated R^2.
    """
    xs = [float(x) for x in xs]
    ys = [float(y) for y in ys]
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError(f"need >= 2 paired points, got {len(xs)}/{len(ys)}")
    n = len(xs)
    if max(xs) - min(xs) <= 0.0:
        raise FitDegenerateError(
            f"all {n} x-values equal ({xs[0]!r}): affine slope is "
            f"unidentifiable; widen the calibration grid axis")

    if max(ys) - min(ys) <= 0.0:
        # Perfectly flat surface: intercept = the constant, slope = 0.
        return AffineFit(intercept=ys[0], slope=0.0, r2=1.0, rmse=0.0,
                         max_abs_residual=0.0, n=n, constant_y=True)

    ws = [1.0] * n
    intercept, slope = _wls(xs, ys, ws)
    for _ in range(_IRLS_ROUNDS):
        resid = [y - (intercept + slope * x) for x, y in zip(xs, ys)]
        # scale via MAD (fall back to rmse when MAD underflows)
        srt = sorted(abs(r) for r in resid)
        mad = srt[n // 2] if n % 2 else 0.5 * (srt[n // 2 - 1] + srt[n // 2])
        scale = 1.4826 * mad or math.sqrt(sum(r * r for r in resid) / n)
        if scale <= 0.0:
            break  # exact fit already
        ws = [1.0 if abs(r) <= _HUBER_K * scale
              else _HUBER_K * scale / abs(r) for r in resid]
        intercept, slope = _wls(xs, ys, ws)

    clamped = False
    if clamp_nonnegative_slope and slope < 0.0:
        # tau surfaces are physically non-decreasing in C and K; a
        # negative fitted slope is timing noise -- clamp and refit the
        # intercept as the (robust-weighted) mean.
        slope = 0.0
        intercept = sum(w * y for w, y in zip(ws, ys)) / sum(ws)
        clamped = True

    resid = [y - (intercept + slope * x) for x, y in zip(xs, ys)]
    ss_res = sum(r * r for r in resid)
    my = sum(ys) / n
    ss_tot = sum((y - my) ** 2 for y in ys)
    return AffineFit(
        intercept=intercept,
        slope=slope,
        r2=1.0 - ss_res / ss_tot,
        rmse=math.sqrt(ss_res / n),
        max_abs_residual=max(abs(r) for r in resid),
        n=n,
        clamped=clamped,
    )


def fit_surfaces(samples: Sequence, *,
                 batch: int = None) -> Dict[str, AffineFit]:
    """Fit both paper surfaces from a flat list of :class:`Sample` s.

    Mixed cells (``mode == "mixed"``) identify ``tau_mix(C)``; solo
    cells identify ``tau_solo(K)``.  Returns ``{"mix": fit, "solo":
    fit}`` where ``mix.intercept = alpha``, ``mix.slope = beta``,
    ``solo.intercept = a_s``, ``solo.slope = b_s``.

    The paper's surfaces are conditioned on a *full* decode batch, so
    the fit uses the reference batch -- ``batch`` if given, else the
    largest batch present.  Cells at smaller batches stay in the sample
    set as batch-sensitivity diagnostics but do not enter the
    regression (iteration time also moves with B, which would otherwise
    contaminate the C/K slopes).
    """
    samples = list(samples)
    if batch is None:
        if not samples:
            raise ValueError("no samples")
        batch = max(s.batch for s in samples)
    mix = [(s.chunk, s.tau) for s in samples
           if s.mode == "mixed" and s.batch == batch]
    solo = [(s.kv, s.tau) for s in samples
            if s.mode == "solo" and s.batch == batch]
    if not mix or not solo:
        raise ValueError(
            f"need both mixed and solo samples (got {len(mix)} mixed, "
            f"{len(solo)} solo)")
    return {
        "mix": fit_affine([x for x, _ in mix], [y for _, y in mix]),
        "solo": fit_affine([x for x, _ in solo], [y for _, y in solo]),
    }
