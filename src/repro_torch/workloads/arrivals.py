"""Arrival processes for the workload-scenario subsystem.

Every process produces a sorted array of arrival times on ``[0, horizon)``
given a :class:`numpy.random.Generator`.  Four families cover the paper's
nonstationary regimes (Section 6.2) plus the classic teletraffic shapes:

* :class:`PoissonArrivals` -- homogeneous rate ``lam``.
* :class:`MMPPArrivals` -- a k-regime Markov-modulated Poisson process
  generalizing the two-state burst model of
  :class:`repro_torch.data.traces.TraceConfig`: regimes cycle ``0 -> 1 -> ...
  -> k-1 -> 0`` with exponential holding times ``1/switch[j]`` and rate
  ``base_rate * levels[j]`` inside regime j (for k = 2 this is exactly
  the existing toggle).
* :class:`PiecewiseConstantArrivals` -- deterministic rate schedule
  ``rates[j]`` on ``[times[j], times[j+1})``; the building block for
  rate-shift steps (:func:`rate_shift`), flash-crowd spikes
  (:func:`flash_crowd`) and binned diurnal curves (:func:`diurnal`).

Sampling is exact (no thinning): homogeneous segments exploit the
memoryless property at every breakpoint, and the MMPP simulates its
regime path explicitly.

**Compression semantics.**  ``scaled(f)`` multiplies the arrival
intensity by ``f``.  For the MMPP it also multiplies the regime-switch
rates, which reproduces the trace generator's interarrival-compression
device exactly (compressing the time axis by ``c`` is the same law as
multiplying *all* process rates by ``1/c``).  Piecewise-constant
schedules keep their authored breakpoints -- a rate shift scripted at
``t = 150 s`` stays at 150 s no matter how hard the load is scaled.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

__all__ = [
    "ArrivalProcess",
    "PoissonArrivals",
    "MMPPArrivals",
    "PiecewiseConstantArrivals",
    "rate_shift",
    "flash_crowd",
    "diurnal",
]


class ArrivalProcess:
    """Protocol-ish base: sample, instantaneous/mean intensity, scaling."""

    def sample(self, rng: np.random.Generator, horizon: float) -> np.ndarray:
        raise NotImplementedError

    def rate_at(self, t: float) -> float:
        """Deterministic intensity at ``t`` (MMPP: its stationary mean)."""
        raise NotImplementedError

    def mean_rate(self, horizon: float) -> float:
        """Time-averaged intensity over ``[0, horizon)``."""
        raise NotImplementedError

    def rate_bound(self) -> float:
        """A finite upper bound on the instantaneous intensity."""
        raise NotImplementedError

    def scaled(self, factor: float) -> "ArrivalProcess":
        """Process with intensity multiplied by ``factor`` (see module doc)."""
        raise NotImplementedError


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    rate: float  # requests/second (cluster level)

    def __post_init__(self) -> None:
        if not self.rate > 0:
            raise ValueError("PoissonArrivals needs rate > 0")

    def sample(self, rng, horizon):
        # draw in chunks: E[count] + slack, extend on the rare shortfall
        out = []
        t = 0.0
        chunk = max(16, int(self.rate * horizon * 1.2) + 16)
        while t < horizon:
            gaps = rng.exponential(1.0 / self.rate, size=chunk)
            ts = t + np.cumsum(gaps)
            out.append(ts[ts < horizon])
            t = float(ts[-1])
        return np.concatenate(out) if out else np.empty(0)

    def rate_at(self, t):
        return self.rate

    def mean_rate(self, horizon):
        return self.rate

    def rate_bound(self):
        return self.rate

    def scaled(self, factor):
        return PoissonArrivals(self.rate * factor)


@dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """k-regime cyclic MMPP (see module docstring)."""

    base_rate: float
    levels: tuple = (0.55, 1.9)  # per-regime rate multipliers
    switch: tuple = (1 / 45.0, 1 / 25.0)  # rate of *leaving* each regime

    def __post_init__(self) -> None:
        if not self.base_rate > 0:
            raise ValueError("MMPPArrivals needs base_rate > 0")
        if len(self.levels) != len(self.switch) or len(self.levels) < 2:
            raise ValueError("levels/switch must align, with >= 2 regimes")
        if any(not lv >= 0 for lv in self.levels):
            raise ValueError("regime levels must be nonnegative")
        if any(not sw > 0 for sw in self.switch):
            raise ValueError("switch rates must be positive")

    @property
    def n_regimes(self) -> int:
        return len(self.levels)

    def sample(self, rng, horizon):
        out = []
        t, j = 0.0, 0
        t_switch = rng.exponential(1.0 / self.switch[j])
        while t < horizon:
            rate = self.base_rate * self.levels[j]
            if rate <= 0:  # silent regime: jump straight to the switch
                t = t_switch
                j = (j + 1) % self.n_regimes
                t_switch = t + rng.exponential(1.0 / self.switch[j])
                continue
            dt = rng.exponential(1.0 / rate)
            if t + dt > t_switch:
                t = t_switch
                j = (j + 1) % self.n_regimes
                t_switch = t + rng.exponential(1.0 / self.switch[j])
                continue
            t += dt
            if t < horizon:
                out.append(t)
        return np.asarray(out)

    def _stationary(self) -> np.ndarray:
        # cycle chain: time share of regime j is proportional to its
        # mean holding time 1/switch[j]
        hold = 1.0 / np.asarray(self.switch, dtype=float)
        return hold / hold.sum()

    def rate_at(self, t):
        return self.mean_rate(0.0)

    def mean_rate(self, horizon):
        pi = self._stationary()
        return float(self.base_rate * (pi * np.asarray(self.levels)).sum())

    def rate_bound(self):
        return float(self.base_rate * max(self.levels))

    def scaled(self, factor):
        # scale switching too: identical in law to compressing the time
        # axis, which is how TraceConfig.compression behaves
        return dataclasses.replace(
            self, base_rate=self.base_rate * factor,
            switch=tuple(s * factor for s in self.switch))


@dataclass(frozen=True)
class PiecewiseConstantArrivals(ArrivalProcess):
    """Rate ``rates[j]`` on ``[times[j], times[j+1])``; ``times[0] == 0``
    and the last rate extends to the sampling horizon."""

    times: tuple
    rates: tuple

    def __post_init__(self) -> None:
        if len(self.times) != len(self.rates) or not self.times:
            raise ValueError("times/rates must be nonempty and align")
        if self.times[0] != 0.0:
            raise ValueError("times must start at 0.0")
        if any(b <= a for a, b in zip(self.times, self.times[1:])):
            raise ValueError("times must be strictly increasing")
        if any(not r >= 0 for r in self.rates):
            raise ValueError("rates must be nonnegative")
        if not any(r > 0 for r in self.rates):
            raise ValueError("at least one segment must have positive rate")

    def sample(self, rng, horizon):
        out = []
        t, j = 0.0, 0
        n_seg = len(self.times)
        while t < horizon:
            t_next = self.times[j + 1] if j + 1 < n_seg else horizon
            t_next = min(t_next, horizon)
            r = self.rates[j]
            if r <= 0:
                t = t_next
                j = min(j + 1, n_seg - 1)
                if t >= horizon:
                    break
                continue
            dt = rng.exponential(1.0 / r)
            if t + dt >= t_next:
                # memoryless: restart at the boundary under the new rate
                t = t_next
                if j + 1 < n_seg:
                    j += 1
                    continue
                break
            t += dt
            out.append(t)
        return np.asarray(out)

    def _segment(self, t: float) -> int:
        return int(np.searchsorted(np.asarray(self.times), t, side="right")
                   - 1)

    def rate_at(self, t):
        return float(self.rates[self._segment(max(t, 0.0))])

    def mean_rate(self, horizon):
        if horizon <= 0:
            return float(self.rates[0])
        edges = [min(t, horizon) for t in self.times] + [horizon]
        total = 0.0
        for j, r in enumerate(self.rates):
            total += r * max(0.0, edges[j + 1] - edges[j])
        return total / horizon

    def rate_bound(self):
        return float(max(self.rates))

    def scaled(self, factor):
        return dataclasses.replace(
            self, rates=tuple(r * factor for r in self.rates))


def rate_shift(rate0: float, rate1: float,
               t_shift: float) -> PiecewiseConstantArrivals:
    """Single step change ``rate0 -> rate1`` at ``t_shift``."""
    return PiecewiseConstantArrivals(times=(0.0, float(t_shift)),
                                     rates=(float(rate0), float(rate1)))


def flash_crowd(base_rate: float, spike_mult: float, t_on: float,
                t_off: float) -> PiecewiseConstantArrivals:
    """Flash crowd: ``base_rate`` except ``base_rate * spike_mult`` on
    ``[t_on, t_off)``."""
    if not 0.0 < t_on < t_off:
        raise ValueError("need 0 < t_on < t_off")
    return PiecewiseConstantArrivals(
        times=(0.0, float(t_on), float(t_off)),
        rates=(float(base_rate), float(base_rate * spike_mult),
               float(base_rate)))


def diurnal(base_rate: float, amplitude: float, period: float,
            horizon: float, n_bins: int = 24) -> PiecewiseConstantArrivals:
    """Piecewise-constant diurnal curve: a sinusoid
    ``base_rate * (1 + amplitude * sin(2 pi t / period))`` binned into
    ``n_bins`` steps per period across ``[0, horizon)``."""
    if not 0 <= amplitude < 1:
        raise ValueError("amplitude must be in [0, 1)")
    if period <= 0 or horizon <= 0 or n_bins < 2:
        raise ValueError("need period > 0, horizon > 0, n_bins >= 2")
    dt = period / n_bins
    n_total = int(np.ceil(horizon / dt))
    times = tuple(k * dt for k in range(n_total))
    mids = np.asarray(times) + dt / 2
    rates = tuple(float(base_rate * (1 + amplitude *
                                     np.sin(2 * np.pi * m / period)))
                  for m in mids)
    return PiecewiseConstantArrivals(times=times, rates=rates)
