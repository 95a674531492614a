"""Pluggable iteration-time models consumed by every engine.

An :class:`IterationTimeModel` answers the two questions the serving
engines ask each iteration:

* ``tau_mix(C)`` -- seconds for a mixed iteration carrying a prefill
  chunk of ``C`` tokens;
* ``tau_solo(K)`` -- seconds for a decode-only iteration with ``K``
  aggregate resident KV tokens;

plus ``primitives()``, the projection onto the queueing-model constants
(:class:`ServicePrimitives`) that the planning LP / CTMC / fluid layers
consume -- so one calibration run reparameterizes the whole stack.

Registry (``MODELS``, names cross-checked against the docs by
``tools/check_docs.py``):

* ``affine`` -- the seed constants.  The default engine path; built so
  its arithmetic is *bitwise identical* to the engines' historical
  inline expressions (same op order: ``alpha + beta * c``).
* ``fitted`` -- an :class:`AffineModel` carrying the surfaces fitted
  from a :class:`CalibrationArtifact`.
* ``table`` -- piecewise-linear interpolation over the artifact's raw
  per-cell medians (constant extrapolation beyond the knots), for when
  the measured surface visibly bends away from affine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

from repro_torch.core.types import DEFAULT_PRIMITIVES, ServicePrimitives

from .fit import fit_affine

__all__ = [
    "DEFAULT_SOLO_KV_SLOPE",
    "MODELS",
    "AffineModel",
    "IterationTimeModel",
    "TableModel",
    "engine_config_for_model",
    "list_models",
    "model_from_artifact",
]

# The engines' historical decode KV slope (paper Sec. 6.2: b_s for the
# A100 calibration); mirrors EngineConfig.solo_kv_slope's default.
DEFAULT_SOLO_KV_SLOPE = 1.08e-7


@runtime_checkable
class IterationTimeModel(Protocol):
    """What the engines require of an iteration-time model."""

    name: str
    kind: str  # "affine" | "table" -- engine_jax's static dispatch key

    def tau_mix(self, chunk: float) -> float: ...

    def tau_solo(self, kv_tokens: float) -> float: ...

    def primitives(self) -> ServicePrimitives: ...


@dataclass(frozen=True)
class AffineModel:
    """The paper's affine surfaces; default parameters = seed constants."""

    alpha: float = DEFAULT_PRIMITIVES.alpha
    beta: float = DEFAULT_PRIMITIVES.beta
    a_s: float = DEFAULT_PRIMITIVES.tau_solo
    b_s: float = DEFAULT_SOLO_KV_SLOPE
    batch_cap: int = DEFAULT_PRIMITIVES.batch_cap
    chunk: int = DEFAULT_PRIMITIVES.chunk
    name: str = "affine"
    kind: str = field(default="affine", init=False)

    def tau_mix(self, chunk: float) -> float:
        # op order matches the engines' historical inline expression
        # (alpha + beta * C) so the default model is bitwise identical
        return self.alpha + self.beta * chunk

    def tau_solo(self, kv_tokens: float) -> float:
        return self.a_s + self.b_s * kv_tokens

    def primitives(self) -> ServicePrimitives:
        return ServicePrimitives(alpha=self.alpha, beta=self.beta,
                                 gamma=1.0 / self.a_s,
                                 batch_cap=self.batch_cap, chunk=self.chunk)

    def jax_params(self) -> Dict[str, float]:
        return {"alpha": self.alpha, "beta": self.beta,
                "tau_solo": self.a_s, "b_s": self.b_s}

    @classmethod
    def from_primitives(cls, prim: ServicePrimitives,
                        solo_kv_slope: float = DEFAULT_SOLO_KV_SLOPE,
                        name: str = "affine") -> "AffineModel":
        return cls(alpha=prim.alpha, beta=prim.beta, a_s=prim.tau_solo,
                   b_s=solo_kv_slope, batch_cap=prim.batch_cap,
                   chunk=prim.chunk, name=name)

    @classmethod
    def from_artifact(cls, art, *, batch_cap: int = 16,
                      chunk: int = 256) -> "AffineModel":
        return cls(alpha=art.alpha, beta=art.beta, a_s=art.a_s,
                   b_s=art.b_s, batch_cap=batch_cap, chunk=chunk,
                   name="fitted")


def _interp(x: float, xs: Tuple[float, ...], ys: Tuple[float, ...]) -> float:
    """Piecewise-linear with constant extrapolation (jnp.interp semantics,
    so engine_sim and engine_jax agree on the table model exactly)."""
    if x <= xs[0]:
        return ys[0]
    if x >= xs[-1]:
        return ys[-1]
    for i in range(1, len(xs)):
        if x <= xs[i]:
            t = (x - xs[i - 1]) / (xs[i] - xs[i - 1])
            return ys[i - 1] + t * (ys[i] - ys[i - 1])
    return ys[-1]  # unreachable


@dataclass(frozen=True)
class TableModel:
    """Interpolated iteration-time surfaces over measured knots."""

    mix_x: Tuple[float, ...]  # chunk knots C
    mix_y: Tuple[float, ...]  # tau_mix at each knot
    solo_x: Tuple[float, ...]  # aggregate-KV knots K
    solo_y: Tuple[float, ...]  # tau_solo at each knot
    batch_cap: int = 16
    chunk: int = 256
    name: str = "table"
    kind: str = field(default="table", init=False)

    def __post_init__(self) -> None:
        for xs, ys, lbl in ((self.mix_x, self.mix_y, "mix"),
                            (self.solo_x, self.solo_y, "solo")):
            if len(xs) != len(ys) or len(xs) < 2:
                raise ValueError(f"table {lbl}: need >= 2 paired knots")
            if list(xs) != sorted(xs):
                raise ValueError(f"table {lbl}: knots must be increasing")

    def tau_mix(self, chunk: float) -> float:
        return _interp(float(chunk), self.mix_x, self.mix_y)

    def tau_solo(self, kv_tokens: float) -> float:
        return _interp(float(kv_tokens), self.solo_x, self.solo_y)

    def primitives(self) -> ServicePrimitives:
        """Affine projection of the knots (the LP/CTMC layers need the
        scalar (alpha, beta, gamma) abstraction regardless)."""
        mix = fit_affine(self.mix_x, self.mix_y)
        solo = fit_affine(self.solo_x, self.solo_y)
        return ServicePrimitives(alpha=mix.intercept, beta=mix.slope,
                                 gamma=1.0 / solo.intercept,
                                 batch_cap=self.batch_cap, chunk=self.chunk)

    def knots(self) -> Dict[str, Tuple[float, ...]]:
        """Knot arrays for engine_jax's jnp.interp step-kernel path."""
        return {"mix_x": self.mix_x, "mix_y": self.mix_y,
                "solo_x": self.solo_x, "solo_y": self.solo_y}

    @classmethod
    def from_artifact(cls, art, *, batch_cap: int = 16,
                      chunk: int = 256) -> "TableModel":
        # knots come from the reference (largest) batch, matching the
        # conditioning convention of fit.fit_surfaces
        ref_b = max(s.batch for s in art.samples)

        def knots(samples, key):
            by_x: Dict[float, list] = {}
            for s in samples:
                by_x.setdefault(float(getattr(s, key)), []).append(s.tau)
            xs = sorted(by_x)
            ys = []
            for x in xs:
                vals = sorted(by_x[x])
                n = len(vals)
                ys.append(vals[n // 2] if n % 2
                          else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))
            return tuple(xs), tuple(ys)

        mx, my = knots([s for s in art.samples
                        if s.mode == "mixed" and s.batch == ref_b], "chunk")
        sx, sy = knots([s for s in art.samples
                        if s.mode == "solo" and s.batch == ref_b], "kv")
        return cls(mix_x=mx, mix_y=my, solo_x=sx, solo_y=sy,
                   batch_cap=batch_cap, chunk=chunk)


def model_from_artifact(art, kind: str = "fitted", **kw) -> IterationTimeModel:
    """Build a model of the given registry ``kind`` from an artifact."""
    if kind not in MODELS:
        raise KeyError(f"unknown model kind {kind!r}; have {list_models()}")
    return MODELS[kind](art, **kw)


# name -> factory(artifact | None, **kw).  "affine" ignores the artifact
# (it IS the seed constants); the artifact-backed kinds require one.
def _make_affine(art=None, **kw) -> AffineModel:
    return AffineModel(**kw)


def _make_fitted(art=None, **kw) -> AffineModel:
    if art is None:
        raise ValueError("model kind 'fitted' needs a CalibrationArtifact")
    return AffineModel.from_artifact(art, **kw)


def _make_table(art=None, **kw) -> TableModel:
    if art is None:
        raise ValueError("model kind 'table' needs a CalibrationArtifact")
    return TableModel.from_artifact(art, **kw)


MODELS: Dict[str, Callable[..., IterationTimeModel]] = {
    "affine": _make_affine,
    "fitted": _make_fitted,
    "table": _make_table,
}


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(MODELS))


def engine_config_for_model(model: IterationTimeModel, *,
                            pricing=None, **engine_kw):
    """An ``EngineConfig`` wired to ``model`` (primitives + iter_model).

    Lazy import keeps :mod:`repro_torch.serving.engine_sim` free of any
    calibration dependency -- the engines only know the protocol.
    """
    from repro_torch.core.types import Pricing
    from repro_torch.serving.engine_sim import EngineConfig

    return EngineConfig(
        prim=model.primitives(),
        pricing=pricing if pricing is not None else Pricing(),
        iter_model=model,
        **engine_kw,
    )
