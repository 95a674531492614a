"""Server heterogeneity: GPU classes, fleets, and KV-transfer costs.

The paper's cluster is homogeneous -- n identical servers sharing one
:class:`~repro_torch.core.types.ServicePrimitives`.  Production fleets mix GPU
generations and pay a real KV-cache handoff cost when a prefill finishes
on one server and its decode continues elsewhere (the DistServe-style
disaggregated pattern).  This module adds the declarative layer:

* :class:`ServerClass` -- one GPU class: an architecture from the
  :mod:`repro_torch.configs` registry whose :class:`ServicePrimitives` are
  resolved through the calibration pipeline (roofline backend, tiny
  grid), a time-scale factor, and a link model (``link_gbps`` +
  ``kv_bytes_per_token``) that prices the KV handoff in seconds per
  prompt token.
* ``SERVER_CLASSES`` -- the named registry (``register_server_class`` /
  ``get_server_class`` / ``list_server_classes``), the reference's
  entries unchanged.
* :class:`FleetSpec` -- a concrete fleet: (class, count) pairs plus a
  global ``xfer_scale`` knob; produces the per-server parameter arrays
  the engines consume and the ``(weight, prim, kv_xfer)`` triples the
  heterogeneous planning LP consumes
  (:func:`repro_torch.core.planning_batch.solve_hetero_batch`, the
  batched interior point, on the card unless ``device="cpu"``).
* Class-aware routing: :func:`class_aware_policies` projects a
  :class:`~repro_torch.core.planning_batch.HeteroPlanSolution` onto per-class
  server pools, each running the paper's homogeneous gate-and-route;
  :func:`blind_primitives` builds the fleet-average primitives a
  class-blind operator would plan with.

See docs/HETEROGENEITY.md for the model and the transfer-cost math.
The module is the reference's ``repro.core.hetero`` with its imports
retargeted and a ``device`` argument on :func:`plan_fleet`.  The
calibrated classes' surfaces come from the roofline backend on the
reference's TPU v5e table (deterministic, no device touched): the
``h100-cal`` class is that gemma2-2b surface scaled by ``speed=0.5``,
a class of the reference's model, not a measurement of an H100.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .planning_batch import HeteroPlanSolution, solve_hetero_plan
from .types import Pricing, ServicePrimitives

__all__ = [
    "ServerClass",
    "SERVER_CLASSES",
    "register_server_class",
    "get_server_class",
    "list_server_classes",
    "resolve_class_primitives",
    "FleetSpec",
    "blind_primitives",
    "class_aware_policies",
    "plan_fleet",
]


@dataclass(frozen=True)
class ServerClass:
    """One GPU class in a heterogeneous fleet.

    ``speed`` is a TIME multiplier (engine_sim straggler convention:
    1.0 nominal, > 1 slower) applied to the resolved iteration-time
    surfaces.  ``link_gbps`` and ``kv_bytes_per_token`` price the
    prefill->decode KV handoff: a finishing prefill of P prompt tokens
    additionally occupies its server for ``kv_sec_per_token * P``
    seconds while the cache ships over the link.  Either set ``arch``
    (primitives resolved via the calibration pipeline) or pass explicit
    ``prim`` / ``b_s`` overrides (the ``paper-a100`` class does this so
    a one-class fleet degenerates bitwise to the homogeneous defaults).
    """

    name: str
    arch: Optional[str] = None  # repro_torch.configs registry key
    speed: float = 1.0  # iteration-time multiplier (>1 = slower GPU)
    link_gbps: float = 200.0  # KV handoff link bandwidth (Gbit/s)
    kv_bytes_per_token: float = 131072.0  # KV-cache bytes per prompt token
    prim: Optional[ServicePrimitives] = None  # explicit override
    b_s: Optional[float] = None  # explicit solo KV slope override (s/token)

    def __post_init__(self) -> None:
        if (self.arch is None) == (self.prim is None):
            raise ValueError(
                f"server class {self.name!r}: set exactly one of arch= "
                f"(calibration-resolved) or prim= (explicit)")
        if self.speed <= 0 or self.link_gbps <= 0:
            raise ValueError(
                f"server class {self.name!r}: speed and link_gbps must be "
                f"positive")
        if self.kv_bytes_per_token < 0:
            raise ValueError(
                f"server class {self.name!r}: kv_bytes_per_token must be "
                f"nonnegative")

    @property
    def kv_sec_per_token(self) -> float:
        """KV handoff seconds per prompt token = bytes/token over link B/W."""
        return self.kv_bytes_per_token / (self.link_gbps * 1e9 / 8.0)


#: Named registry (the reference's entries).
SERVER_CLASSES: dict = {}


def register_server_class(sc: ServerClass) -> ServerClass:
    if sc.name in SERVER_CLASSES:
        raise ValueError(f"server class {sc.name!r} already registered")
    SERVER_CLASSES[sc.name] = sc
    return sc


def get_server_class(name: str) -> ServerClass:
    try:
        return SERVER_CLASSES[name]
    except KeyError:
        raise KeyError(
            f"unknown server class {name!r}; registered: "
            f"{sorted(SERVER_CLASSES)}") from None


def list_server_classes() -> list:
    return sorted(SERVER_CLASSES)


# The paper's homogeneous calibration as a degenerate class: explicit
# default primitives (no calibration round-trip), nominal speed, and the
# engine_sim default solo KV slope -- a one-class paper-a100 fleet with
# xfer_scale=0 reproduces the homogeneous engines bitwise.
register_server_class(ServerClass(
    name="paper-a100", prim=ServicePrimitives(), b_s=1.08e-7,
    link_gbps=200.0, kv_bytes_per_token=131072.0))
# Calibration-resolved generations: the A-class is the nominal datum,
# the H-class trades ~2x faster iterations for a faster link, and the
# L-class is an older, slower part behind a thinner link (where KV
# handoff hurts most).  All three are the reference's roofline surfaces
# on the v5e table, scaled by ``speed``; none is a measured card.
register_server_class(ServerClass(
    name="a100-cal", arch="gemma2-2b", speed=1.0,
    link_gbps=200.0, kv_bytes_per_token=131072.0))
register_server_class(ServerClass(
    name="h100-cal", arch="gemma2-2b", speed=0.5,
    link_gbps=400.0, kv_bytes_per_token=131072.0))
register_server_class(ServerClass(
    name="l4-cal", arch="qwen2-0.5b", speed=2.5,
    link_gbps=50.0, kv_bytes_per_token=65536.0))


_CALIB_CACHE: dict = {}


def _calibrated(arch: str):
    """Calibration artifact for ``arch`` (roofline backend, tiny grid,
    reduced config -- the deterministic analytic surface), cached."""
    if arch not in _CALIB_CACHE:
        from repro_torch.calibration.grid import CalibrationGrid
        from repro_torch.calibration.run import calibrate

        _CALIB_CACHE[arch] = calibrate(
            arch, grid=CalibrationGrid.tiny(), backend="roofline",
            reduced=True)
    return _CALIB_CACHE[arch]


def resolve_class_primitives(sc: ServerClass, *, batch_cap: int = 16,
                             chunk: int = 256) -> tuple:
    """``(ServicePrimitives, b_s)`` for one class, speed-scaled.

    ``batch_cap`` / ``chunk`` are fleet-uniform (the engines' pointer
    tables and ring sizes assume one B and one chunk); classes differ in
    their time surfaces only.  ``speed`` multiplies every time constant:
    ``alpha * s``, ``beta * s``, ``tau_solo * s`` (i.e. ``gamma / s``),
    ``b_s * s``.
    """
    if sc.prim is not None:
        base, b_s = sc.prim, (1.08e-7 if sc.b_s is None else sc.b_s)
        alpha, beta, gamma = base.alpha, base.beta, base.gamma
    else:
        art = _calibrated(sc.arch)
        alpha, beta, gamma = art.alpha, art.beta, 1.0 / art.a_s
        b_s = art.b_s
    s = float(sc.speed)
    prim = ServicePrimitives(alpha=alpha * s, beta=beta * s,
                             gamma=gamma / s, batch_cap=batch_cap,
                             chunk=chunk)
    return prim, float(b_s) * s


@dataclass(frozen=True)
class FleetSpec:
    """A concrete heterogeneous fleet: (class, count) pairs.

    ``xfer_scale`` multiplies every class's ``kv_sec_per_token`` --
    0 turns the KV handoff charge off entirely (the engines' hot paths
    then stay bitwise identical to the homogeneous build), 1 is the
    physical link model, > 1 sweeps degraded interconnects.  Servers are
    assigned to classes in contiguous blocks (class 0 owns servers
    ``0..counts[0]-1``, etc.).
    """

    classes: tuple  # tuple[ServerClass, ...]
    counts: tuple  # tuple[int, ...]
    xfer_scale: float = 1.0

    def __post_init__(self) -> None:
        if len(self.classes) == 0 or len(self.classes) != len(self.counts):
            raise ValueError("FleetSpec needs matching non-empty "
                             "classes/counts")
        if any(int(c) <= 0 for c in self.counts):
            raise ValueError("FleetSpec counts must be positive")
        if self.xfer_scale < 0:
            raise ValueError("xfer_scale must be nonnegative")
        object.__setattr__(self, "classes", tuple(self.classes))
        object.__setattr__(self, "counts",
                           tuple(int(c) for c in self.counts))

    @classmethod
    def of(cls, spec: Sequence[tuple], xfer_scale: float = 1.0
           ) -> "FleetSpec":
        """From ``[(class_name_or_ServerClass, count), ...]``."""
        classes = tuple(get_server_class(s) if isinstance(s, str) else s
                        for s, _ in spec)
        return cls(classes, tuple(int(k) for _, k in spec),
                   xfer_scale=xfer_scale)

    @property
    def n(self) -> int:
        return sum(self.counts)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def weights(self) -> np.ndarray:
        return np.asarray(self.counts, dtype=np.float64) / self.n

    def assignment(self) -> np.ndarray:
        """(n,) int32 class index per server (contiguous blocks)."""
        return np.repeat(np.arange(len(self.classes), dtype=np.int32),
                         self.counts)

    def resolved(self, base: Optional[ServicePrimitives] = None) -> list:
        """Per-class ``(prim, b_s, kv_xfer)`` triples (fleet-uniform
        B/chunk from ``base``)."""
        base = base or ServicePrimitives()
        out = []
        for sc in self.classes:
            prim, b_s = resolve_class_primitives(
                sc, batch_cap=base.batch_cap, chunk=base.chunk)
            out.append((prim, b_s,
                        float(self.xfer_scale) * sc.kv_sec_per_token))
        return out

    def planner_fleet(self, base: Optional[ServicePrimitives] = None
                      ) -> list:
        """``(weight, prim, kv_xfer)`` triples for
        :func:`repro_torch.core.planning_batch.solve_hetero_batch`."""
        w = self.weights
        return [(float(w[c]), prim, kv)
                for c, (prim, _, kv) in enumerate(self.resolved(base))]

    def server_params(self, base: Optional[ServicePrimitives] = None
                      ) -> dict:
        """Per-server (n,) float64 parameter arrays for the engines:
        ``alpha``, ``beta``, ``tau_solo``, ``b_s``, ``kv_xfer``, plus
        the (n,) int32 ``cls`` assignment."""
        res = self.resolved(base)
        idx = self.assignment()
        pick = lambda vals: np.asarray(vals, dtype=np.float64)[idx]  # noqa: E731
        return {
            "cls": idx,
            "alpha": pick([p.alpha for p, _, _ in res]),
            "beta": pick([p.beta for p, _, _ in res]),
            "tau_solo": pick([p.tau_solo for p, _, _ in res]),
            "b_s": pick([b for _, b, _ in res]),
            "kv_xfer": pick([k for _, _, k in res]),
        }


def blind_primitives(fleet: FleetSpec,
                     base: Optional[ServicePrimitives] = None) -> tuple:
    """``(ServicePrimitives, b_s, kv_xfer)`` a class-blind operator sees.

    Fleet-share-weighted averages of the TIME surfaces (``alpha``,
    ``beta``, ``tau_solo``, ``b_s``, ``kv_xfer``) -- what a single
    calibration run against a mixed fleet would fit.  The blind baseline
    plans the homogeneous Eq. 40 LP with these and runs ONE
    gate-and-route over the whole mixed fleet.
    """
    base = base or ServicePrimitives()
    res = fleet.resolved(base)
    w = fleet.weights
    avg = lambda vals: float(np.dot(w, np.asarray(vals)))  # noqa: E731
    prim = ServicePrimitives(
        alpha=avg([p.alpha for p, _, _ in res]),
        beta=avg([p.beta for p, _, _ in res]),
        gamma=1.0 / avg([p.tau_solo for p, _, _ in res]),
        batch_cap=base.batch_cap, chunk=base.chunk)
    return prim, avg([b for _, b, _ in res]), avg([k for _, _, k in res])


def plan_fleet(classes, fleet: FleetSpec,
               pricing: Optional[Pricing] = None, *,
               base: Optional[ServicePrimitives] = None,
               objective: str = "bundled", device=None) -> HeteroPlanSolution:
    """Heterogeneous fluid plan for ``fleet`` (single LP solve, the
    batched interior point on ``device``: the card unless ``"cpu"``)."""
    return solve_hetero_plan(classes, fleet.planner_fleet(base), pricing,
                             objective=objective, device=device)


def class_aware_policies(hplan: HeteroPlanSolution) -> list:
    """Per-pool gate-and-route policies from a heterogeneous plan.

    Pool ``c`` (the fleet's class-c servers) runs the paper's
    homogeneous gate-and-route instantiated from the plan's class-c
    projection (:meth:`HeteroPlanSolution.pool_plan`); arrivals are
    split across pools with :meth:`HeteroPlanSolution.split_probs`.
    """
    from .policies import gate_and_route

    return [gate_and_route(hplan.pool_plan(c),
                           name=f"gate_and_route_pool{c}")
            for c in range(hplan.n_server_classes)]
