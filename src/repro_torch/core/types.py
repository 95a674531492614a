"""Primitive types for the prefill-decode contention control framework.

These mirror the paper's Section 2 notation:

* :class:`WorkloadClass` -- a request class i with (P_i, D_i, lambda_i, theta_i).
* :class:`ServicePrimitives` -- iteration-time abstraction (alpha, beta, gamma, B, C)
  and the induced service rates mu_{p,i}, mu_{m,i}, mu_{s,i} of Eq. (4).
* :class:`Pricing` -- token prices (c_p, c_d) and the bundled reward w_i (Eq. 21).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "WorkloadClass",
    "ServicePrimitives",
    "Pricing",
    "ClassRates",
    "rates_for",
    "resolve_primitives",
    "DEFAULT_PRIMITIVES",
]


@dataclass(frozen=True)
class WorkloadClass:
    """A request class: representative prompt/decode lengths and traffic."""

    name: str
    prompt_len: float  # P_i (tokens)
    decode_len: float  # D_i (tokens)
    arrival_rate: float  # lambda_i, per *logical server* per second
    patience: float = 0.0  # theta_i >= 0 (exponential abandonment rate)

    def __post_init__(self) -> None:
        if self.prompt_len <= 0 or self.decode_len <= 0:
            raise ValueError(f"class {self.name}: token lengths must be positive")
        if self.arrival_rate < 0 or self.patience < 0:
            raise ValueError(f"class {self.name}: rates must be nonnegative")


@dataclass(frozen=True)
class ServicePrimitives:
    """Iteration-time abstraction (Section 2.2).

    tau_mix(C) = alpha + beta * C   (mixed iteration: one prefill chunk present)
    tau_solo   = 1 / gamma          (decode-only iteration)

    B is the per-server decode-stream cap; C the prefill chunk size (tokens).
    Defaults are the paper's A100 / Qwen3-8B calibration (Section 6.1).
    """

    alpha: float = 0.0174
    beta: float = 6.2e-5
    gamma: float = 1.0 / 0.0089  # 1 / tau_solo
    batch_cap: int = 16  # B
    chunk: int = 256  # C

    def __post_init__(self) -> None:
        if self.alpha <= 0 or self.beta < 0 or self.gamma <= 0:
            raise ValueError("invalid iteration-time primitives")
        if self.batch_cap < 2 or self.chunk < 1:
            raise ValueError("need B >= 2 and C >= 1")

    @property
    def tau_mix(self) -> float:
        """Mixed iteration time tau = alpha + beta * C (Eq. 3)."""
        return self.alpha + self.beta * self.chunk

    @property
    def tau_solo(self) -> float:
        return 1.0 / self.gamma

    @property
    def solo_efficiency_ok(self) -> bool:
        """Proposition 1's calibrated-regime condition gamma*tau >= (B-1)/B."""
        return self.gamma * self.tau_mix >= (self.batch_cap - 1) / self.batch_cap

    @property
    def kappa(self) -> float:
        """Mode speed ratio kappa = mu_s / mu_m = gamma * tau (class independent)."""
        return self.gamma * self.tau_mix

    def with_(self, **kw) -> "ServicePrimitives":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ClassRates:
    """Service rates of Eq. (4) for one class."""

    mu_p: float  # prefill completion rate C / (P_i * tau)
    mu_m: float  # mixed-mode decode completion rate 1 / (D_i * tau)
    mu_s: float  # solo-mode decode completion rate gamma / D_i


def resolve_primitives(prim) -> ServicePrimitives:
    """Accept a :class:`ServicePrimitives` or anything exposing the
    calibration ``IterationTimeModel`` protocol (a ``primitives()``
    method) -- so planning/CTMC/fluid entry points can consume a fitted
    iteration-time model directly."""
    if isinstance(prim, ServicePrimitives):
        return prim
    getter = getattr(prim, "primitives", None)
    if callable(getter):
        out = getter()
        if isinstance(out, ServicePrimitives):
            return out
    raise TypeError(
        f"expected ServicePrimitives or an IterationTimeModel with a "
        f".primitives() method, got {type(prim).__name__}")


def rates_for(cls: WorkloadClass, prim: ServicePrimitives,
              kv_xfer: float = 0.0) -> ClassRates:
    """Per-class service rates (Eq. 4), optionally transfer-adjusted.

    ``kv_xfer`` is the KV handoff charge in seconds per prompt token
    (KV bytes/token over link bandwidth; see docs/HETEROGENEITY.md): a
    finishing prefill additionally occupies its server for
    ``kv_xfer * P_i`` seconds while the cache ships to the decode pool,
    so the effective prefill service time is ``P_i tau / chunk +
    kv_xfer * P_i``.  The ``kv_xfer == 0`` branch is taken in Python so
    the legacy expression (and its bitwise value) is untouched for
    every existing homogeneous caller.
    """
    prim = resolve_primitives(prim)
    tau = prim.tau_mix
    if kv_xfer == 0.0:
        mu_p = prim.chunk / (cls.prompt_len * tau)
    else:
        mu_p = 1.0 / (cls.prompt_len * tau / prim.chunk
                      + kv_xfer * cls.prompt_len)
    return ClassRates(
        mu_p=mu_p,
        mu_m=1.0 / (cls.decode_len * tau),
        mu_s=prim.gamma / cls.decode_len,
    )


@dataclass(frozen=True)
class Pricing:
    """Per-token prices; bundled reward w_i = c_p P_i + c_d D_i (Eq. 21)."""

    c_p: float = 0.1
    c_d: float = 0.2

    def bundled_reward(self, cls: WorkloadClass) -> float:
        return self.c_p * cls.prompt_len + self.c_d * cls.decode_len

    def prefill_reward(self, cls: WorkloadClass) -> float:
        return self.c_p * cls.prompt_len

    def decode_reward(self, cls: WorkloadClass) -> float:
        return self.c_d * cls.decode_len


DEFAULT_PRIMITIVES = ServicePrimitives()


def rate_arrays(
    classes: Sequence[WorkloadClass], prim: ServicePrimitives,
    kv_xfer: float = 0.0,
) -> dict[str, np.ndarray]:
    """Vectorised per-class parameter arrays used by the LP/fluid/simulator."""
    prim = resolve_primitives(prim)
    rr = [rates_for(c, prim, kv_xfer) for c in classes]
    return {
        "lam": np.array([c.arrival_rate for c in classes], dtype=np.float64),
        "theta": np.array([c.patience for c in classes], dtype=np.float64),
        "P": np.array([c.prompt_len for c in classes], dtype=np.float64),
        "D": np.array([c.decode_len for c in classes], dtype=np.float64),
        "mu_p": np.array([r.mu_p for r in rr], dtype=np.float64),
        "mu_m": np.array([r.mu_m for r in rr], dtype=np.float64),
        "mu_s": np.array([r.mu_s for r in rr], dtype=np.float64),
    }
