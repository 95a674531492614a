"""Schema for batched policy sweeps: ``SweepSpec`` in, ``SweepResult`` out.

A sweep evaluates the cross product

    workload mix  x  policy  x  cluster size n  x  seed replication

under one of seven evaluators (aggregate CTMC, its batched uniformized
twin on the card, the batched fluid ODE, planning LP, the planning LP's
batched interior-point twin, per-server trace engine, and the trace
engine's batched twin) and emits a single JSON artifact that
every benchmark shares.  Randomness is fully determined by ``SweepSpec.seed``:
each grid cell derives its own :class:`numpy.random.SeedSequence` from the
cell's *coordinates*, so results are independent of iteration order and
bitwise reproducible (see :func:`cell_seed_sequence`).

The schema is the reference's (``repro.sweep.spec``), field for field,
with the reference's evaluator names: the same grid gives the same spec
JSON and so the same ``spec_sha256``.  The device a sweep runs on is not
a spec field; it is an argument of :func:`repro_torch.sweep.run_sweep`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass

__all__ = [
    "SCHEMA_VERSION",
    "EVALUATORS",
    "Evaluator",
    "register_evaluator",
    "get_evaluator",
    "MixSpec",
    "SweepSpec",
    "CellResult",
    "SweepResult",
    "SweepSchemaError",
    "cell_seed_sequence",
    "validate_payload",
]

SCHEMA_VERSION = 1
EVALUATORS = ("ctmc", "ctmc_jax", "fluid", "lp", "lp_jax", "engine",
              "engine_jax")


class SweepSchemaError(ValueError):
    """A sweep payload does not conform to the published schema."""


@dataclass(frozen=True)
class MixSpec:
    """One workload mix: request classes plus instance overrides.

    ``classes`` holds :class:`WorkloadClass` kwargs dicts (empty for the
    "engine" evaluator, which derives planner classes from the trace).
    ``prim`` / ``pricing`` override :class:`ServicePrimitives` /
    :class:`Pricing` fields; ``trace`` overrides
    :class:`repro_torch.data.traces.TraceConfig` fields and additionally accepts
    ``compression_per_server`` (compression is then ``value / n``, keeping
    per-server offered load constant across cluster sizes).

    ``scenario`` names a registered workload scenario
    (:func:`repro_torch.workloads.get_scenario`); when set, the trace-driven
    evaluators (``engine`` / ``engine_jax``) generate the trace from the
    scenario instead of the raw ``TraceConfig``, and ``trace`` overrides
    narrow to the :meth:`Scenario.generate` knobs (``seed``,
    ``horizon``, ``compression`` / ``compression_per_server``,
    ``rate_scale``).  This is the sweep's *scenario axis*: one mix per
    scenario name (``python -m repro_torch.sweep.run --scenarios ...``).
    """

    name: str = "default"
    classes: tuple = ()
    prim: dict = field(default_factory=dict)
    pricing: dict = field(default_factory=dict)
    trace: dict = field(default_factory=dict)
    scenario: str = ""

    def workload_classes(self) -> tuple:
        return tuple(WorkloadClass(**dict(c)) for c in self.classes)

    def primitives(self) -> ServicePrimitives:
        return ServicePrimitives(**self.prim)

    def price(self) -> Pricing:
        return Pricing(**self.pricing)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "classes": [dict(c) for c in self.classes],
            "prim": dict(self.prim),
            "pricing": dict(self.pricing),
            "trace": dict(self.trace),
            "scenario": self.scenario,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MixSpec":
        return cls(
            name=d.get("name", "default"),
            classes=tuple(dict(c) for c in d.get("classes", ())),
            prim=dict(d.get("prim", {})),
            pricing=dict(d.get("pricing", {})),
            trace=dict(d.get("trace", {})),
            scenario=d.get("scenario", ""),
        )


@dataclass(frozen=True)
class SweepSpec:
    """Full description of a policy-sweep grid (JSON round-trippable)."""

    name: str = "sweep"
    evaluator: str = "ctmc"  # one of EVALUATORS
    policies: tuple = ("gate_and_route",)
    n_servers: tuple = (50,)
    n_seeds: int = 1
    seed: int = 0  # master entropy; cells derive their own streams
    mixes: tuple = (MixSpec(),)
    horizon: float = 200.0
    warmup: float = 50.0
    record_every: float = 0.0
    extra: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.evaluator not in EVALUATORS:
            raise SweepSchemaError(
                f"evaluator {self.evaluator!r} not in {EVALUATORS}")
        if not self.policies or not self.n_servers or not self.mixes:
            raise SweepSchemaError("policies/n_servers/mixes must be nonempty")
        if self.n_seeds < 1:
            raise SweepSchemaError("n_seeds must be >= 1")

    @property
    def n_cells(self) -> int:
        return (len(self.mixes) * len(self.policies) * len(self.n_servers)
                * self.n_seeds)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["policies"] = list(self.policies)
        d["n_servers"] = [int(n) for n in self.n_servers]
        d["mixes"] = [m.to_dict() for m in self.mixes]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SweepSpec":
        return cls(
            name=d.get("name", "sweep"),
            evaluator=d.get("evaluator", "ctmc"),
            policies=tuple(d.get("policies", ("gate_and_route",))),
            n_servers=tuple(int(n) for n in d.get("n_servers", (50,))),
            n_seeds=int(d.get("n_seeds", 1)),
            seed=int(d.get("seed", 0)),
            mixes=tuple(MixSpec.from_dict(m)
                        for m in d.get("mixes", ({},))),
            horizon=float(d.get("horizon", 200.0)),
            warmup=float(d.get("warmup", 50.0)),
            record_every=float(d.get("record_every", 0.0)),
            extra=dict(d.get("extra", {})),
        )


def cell_seed_sequence(spec: SweepSpec, mix_i: int, policy_i: int,
                       n_i: int, seed_i: int) -> np.random.SeedSequence:
    """Independent, coordinate-keyed RNG stream for one grid cell.

    The entropy is ``(spec.seed, mix, policy, n, seed)`` *indices*, so the
    same spec always yields the same stream per cell no matter how the grid
    is iterated or parallelised, and adding values to one axis never
    perturbs the streams of existing cells on the other axes.
    """
    return np.random.SeedSequence(
        entropy=(int(spec.seed), mix_i, policy_i, n_i, seed_i))


def cell_int_seed(ss: np.random.SeedSequence) -> int:
    """Collapse a cell stream to an int for engines that take int seeds."""
    return int(ss.generate_state(1, np.uint32)[0])


# ---------------------------------------------------------------------------
# Evaluator protocol: one call signature for every engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Evaluator:
    """One registered sweep evaluator behind the uniform protocol.

    Calling it evaluates one (mix, policy, n) cell group::

        evaluator(ctx, token, n, seeds=streams, **extra)
            -> list[CellResult]   # one per seed replication

    ``ctx`` is the :class:`~repro_torch.sweep.evaluators.MixContext`, ``token``
    a policy token, ``n`` the cluster size, ``seeds`` the cell's
    :class:`numpy.random.SeedSequence` streams (one per replication) and
    ``extra`` evaluator-specific overrides (e.g. ``placement=`` for the
    batched engines) that default from ``ctx.spec.extra``.

    ``fn`` implements the cell group and returns metric dicts -- a list
    (one per seed), or for ``deterministic`` evaluators a single dict
    that is replicated over the seed axis.  ``prepare(contexts,
    policies, extra)`` is an optional whole-grid hook the runner calls
    once up front; the grid-batched evaluators (fluid ODE, batched
    planning LP) use it to solve the full (mix x policy) plane in ONE
    batched run and cache per-cell metrics on the contexts.
    """

    name: str
    fn: Callable
    deterministic: bool = False
    prepare: Optional[Callable] = None

    def __call__(self, ctx, token: str, n: int, *, seeds, **extra) -> list:
        out = self.fn(ctx, token, n, seeds=seeds, **extra)
        if self.deterministic:
            metrics = [dict(out) for _ in seeds]
        else:
            metrics = [dict(m) for m in out]
            if len(metrics) != len(seeds):
                raise SweepSchemaError(
                    f"evaluator {self.name!r} returned {len(metrics)} "
                    f"metric dicts for {len(seeds)} seeds")
        return [CellResult(ctx.mix.name, token, int(n), si, m)
                for si, m in enumerate(metrics)]


EVALUATOR_REGISTRY: Dict[str, Evaluator] = {}


def register_evaluator(name: str, *, deterministic: bool = False,
                       prepare: Optional[Callable] = None) -> Callable:
    """Decorator: register ``fn`` as the evaluator behind ``name``.

    The canonical names live in :data:`EVALUATORS`; the built-in
    implementations register themselves on first import of
    :mod:`repro_torch.sweep.evaluators`.
    """

    def deco(fn: Callable) -> Callable:
        EVALUATOR_REGISTRY[name] = Evaluator(
            name=name, fn=fn, deterministic=deterministic, prepare=prepare)
        return fn

    return deco


def get_evaluator(name: str) -> Evaluator:
    """The :class:`Evaluator` registered under ``name``."""
    if name not in EVALUATOR_REGISTRY:
        import repro_torch.sweep.evaluators  # noqa: F401 - registers built-ins
    try:
        return EVALUATOR_REGISTRY[name]
    except KeyError:
        raise SweepSchemaError(
            f"no evaluator registered under {name!r} "
            f"(known: {sorted(EVALUATOR_REGISTRY)})") from None


@dataclass
class CellResult:
    """Scalar metrics of one grid cell (per-class metrics are flattened
    as ``"<metric>/<class index>"`` keys).

    Non-finite metrics (e.g. ``ttft_mean`` when nothing completed within
    the horizon) serialise as JSON ``null`` -- never the bare ``NaN``
    token, which strict JSON parsers reject -- and load back as NaN.
    """

    mix: str
    policy: str
    n: int
    seed: int  # seed *index* on the replication axis
    metrics: dict

    def to_dict(self) -> dict:
        def enc(v):
            v = float(v)
            return v if math.isfinite(v) else None

        return {"mix": self.mix, "policy": self.policy, "n": int(self.n),
                "seed": int(self.seed),
                "metrics": {k: enc(v) for k, v in self.metrics.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "CellResult":
        return cls(mix=d["mix"], policy=d["policy"], n=int(d["n"]),
                   seed=int(d["seed"]),
                   metrics={k: (float("nan") if v is None else float(v))
                            for k, v in d["metrics"].items()})


@dataclass
class SweepResult:
    """All cells of one sweep + the spec that produced them."""

    spec: SweepSpec
    cells: list
    meta: dict = field(default_factory=dict)

    # -- queries ---------------------------------------------------------------
    def select(self, *, mix: Optional[str] = None,
               policy: Optional[str] = None,
               n: Optional[int] = None,
               seed: Optional[int] = None) -> list:
        out = []
        for c in self.cells:
            if mix is not None and c.mix != mix:
                continue
            if policy is not None and c.policy != policy:
                continue
            if n is not None and c.n != n:
                continue
            if seed is not None and c.seed != seed:
                continue
            out.append(c)
        return out

    def metric(self, name: str, **filters) -> np.ndarray:
        """Metric values over matching cells (grid order)."""
        return np.array([c.metrics[name] for c in self.select(**filters)])

    def mean_over_seeds(self, name: str, **filters) -> float:
        vals = self.metric(name, **filters)
        return float(np.mean(vals)) if vals.size else float("nan")

    # -- serialisation ---------------------------------------------------------
    def to_payload(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "spec": self.spec.to_dict(),
            "cells": [c.to_dict() for c in self.cells],
            "meta": dict(self.meta),
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "SweepResult":
        validate_payload(payload)
        return cls(
            spec=SweepSpec.from_dict(payload["spec"]),
            cells=[CellResult.from_dict(c) for c in payload["cells"]],
            meta=dict(payload.get("meta", {})),
        )

    def fingerprint(self) -> str:
        """Deterministic digest of spec + cells (meta excluded: it carries
        wall-clock runtime, which legitimately varies between runs)."""
        import hashlib

        p = self.to_payload()
        blob = json.dumps({"spec": p["spec"], "cells": p["cells"]},
                          sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def save(self, path) -> Path:
        path = Path(path)
        payload = self.to_payload()
        validate_payload(payload)  # never write a non-conforming artifact
        path.parent.mkdir(parents=True, exist_ok=True)
        # allow_nan=False backstops the null encoding of non-finite metrics
        path.write_text(json.dumps(payload, indent=1, allow_nan=False))
        return path

    @classmethod
    def load(cls, path) -> "SweepResult":
        return cls.from_payload(json.loads(Path(path).read_text()))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SweepSchemaError(msg)


def validate_payload(payload: dict) -> None:
    """Structural validation of a sweep artifact; raises SweepSchemaError."""
    _require(isinstance(payload, dict), "payload must be an object")
    for key in ("schema_version", "spec", "cells"):
        _require(key in payload, f"missing top-level key {key!r}")
    _require(payload["schema_version"] == SCHEMA_VERSION,
             f"schema_version must be {SCHEMA_VERSION}")
    spec = payload["spec"]
    _require(isinstance(spec, dict), "spec must be an object")
    for key in ("name", "evaluator", "policies", "n_servers", "n_seeds",
                "seed", "mixes", "horizon", "warmup"):
        _require(key in spec, f"spec missing key {key!r}")
    _require(spec["evaluator"] in EVALUATORS,
             f"unknown evaluator {spec['evaluator']!r}")
    _require(isinstance(spec["policies"], list) and spec["policies"],
             "spec.policies must be a nonempty list")
    _require(isinstance(spec["n_servers"], list) and spec["n_servers"],
             "spec.n_servers must be a nonempty list")
    _require(isinstance(spec["mixes"], list) and spec["mixes"],
             "spec.mixes must be a nonempty list")
    for m in spec["mixes"]:
        _require(isinstance(m, dict) and "name" in m,
                 "each mix must be an object with a name")
    cells = payload["cells"]
    _require(isinstance(cells, list), "cells must be a list")
    mix_names = {m["name"] for m in spec["mixes"]}
    policies = set(spec["policies"])
    for c in cells:
        _require(isinstance(c, dict), "each cell must be an object")
        for key in ("mix", "policy", "n", "seed", "metrics"):
            _require(key in c, f"cell missing key {key!r}")
        _require(c["mix"] in mix_names, f"cell mix {c['mix']!r} not in spec")
        _require(c["policy"] in policies,
                 f"cell policy {c['policy']!r} not in spec")
        _require(isinstance(c["metrics"], dict) and c["metrics"],
                 "cell metrics must be a nonempty object")
        for k, v in c["metrics"].items():
            _require(isinstance(k, str), "metric keys must be strings")
            _require(v is None or (isinstance(v, (int, float))
                                   and not isinstance(v, bool)),
                     f"metric {k!r} must be a number or null (non-finite)")
