"""Declarative workload scenarios + the scenario registry.

A :class:`Scenario` names a *class mix* (tuple of
:class:`repro_torch.data.traces.ClassProfile`, with per-class patience), an
:class:`repro_torch.workloads.arrivals.ArrivalProcess`, an optional
*mix schedule* (time-varying class shares -- the device behind the
``rate_shift`` scenario's composition shift), and an optional
*capacity-event script* (server failures/joins/stragglers that feed
``ClusterEngine.run(failure_events=...)`` and, through it,
``OnlineController.set_capacity``).  ``generate()`` emits a validated
``list[Request]`` and ``tensorize()`` packs it straight into
:class:`repro_torch.data.traces.TraceTensors` for the batched engines.

The registry (:func:`register_scenario` / :func:`get_scenario` /
:func:`list_scenarios`) ships a catalog spanning stationary to
adversarial: the Azure-like slices the benchmarks replayed with
hand-rolled ``TraceConfig`` blocks, Dolly/agentic/RAG/reasoning mixes,
and the nonstationary shapes (diurnal, flash crowd, rate shift,
capacity churn) the online controller exists for.  The catalog table in
``docs/WORKLOADS.md`` is cross-checked against this registry by
``tools/check_docs.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.data.traces import (ClassProfile, Request, TraceTensors,
                               sample_lengths, tensorize_trace,
                               validate_requests)

from .arrivals import (ArrivalProcess, MMPPArrivals, PoissonArrivals, diurnal,
                       flash_crowd, rate_shift)

__all__ = [
    "CapacityEvent",
    "EVENT_KINDS",
    "Scenario",
    "ScenarioError",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
]


class ScenarioError(KeyError):
    """Unknown scenario name or invalid scenario definition."""


#: Capacity-event verbs the engine understands; docs/HETEROGENEITY.md
#: must document every kind and ``tools/check_docs.py`` enforces both
#: directions.
EVENT_KINDS = ("fail", "recover", "straggle", "degrade")


@dataclass(frozen=True)
class CapacityEvent:
    """One scripted elasticity event.

    ``kind`` is one of the engine's event verbs: ``"fail"`` /
    ``"recover"`` (elastic capacity, replanned via
    ``OnlineController.set_capacity``), ``"straggle"`` (iteration-time
    multiplier ``speed``) or ``"degrade"`` (KV handoff link bandwidth
    fraction ``speed``; 1.0 restores -- replans WITHOUT a capacity
    change).  ``sid`` is the target server id; scripts are authored
    against the scenario's recommended cluster size and the harness
    clamps ids to the actual ``n``.
    """

    t: float
    kind: str  # one of EVENT_KINDS
    sid: int
    speed: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown capacity event kind {self.kind!r}")
        if self.t < 0 or self.sid < 0 or self.speed <= 0:
            raise ValueError("capacity events need t, sid >= 0 and speed > 0")

    def as_tuple(self, n: Optional[int] = None) -> tuple:
        """Engine-format event; clamps ``sid`` into ``[0, n)`` if given."""
        sid = self.sid if n is None else min(self.sid, n - 1)
        if self.kind in ("straggle", "degrade"):
            return (self.t, self.kind, sid, self.speed)
        return (self.t, self.kind, sid)


@dataclass(frozen=True)
class Scenario:
    """A named, fully declarative workload scenario (see module doc)."""

    name: str
    description: str
    profiles: tuple  # ClassProfile per class
    arrivals: ArrivalProcess
    horizon: float = 300.0
    # optional nonstationary class mix: ((t, shares), ...); shares at time
    # t' are those of the last entry with t <= t', else the profile shares
    mix_schedule: tuple = ()
    capacity_events: tuple = ()  # CapacityEvent script
    seed: int = 0
    tags: tuple = ()  # free-form labels ("stationary", "bursty", ...)

    def __post_init__(self) -> None:
        if not self.profiles:
            raise ValueError(f"scenario {self.name!r} has no profiles")
        I = len(self.profiles)
        for t, shares in self.mix_schedule:
            if len(shares) != I:
                raise ValueError(
                    f"scenario {self.name!r}: mix_schedule entry at t={t} "
                    f"has {len(shares)} shares for {I} classes")
            if t < 0 or not all(s >= 0 for s in shares) or sum(shares) <= 0:
                raise ValueError(
                    f"scenario {self.name!r}: invalid mix_schedule entry "
                    f"at t={t}")
        sched_ts = [t for t, _ in self.mix_schedule]
        if sched_ts != sorted(sched_ts) or len(set(sched_ts)) != len(sched_ts):
            raise ValueError(
                f"scenario {self.name!r}: mix_schedule times must be "
                f"strictly increasing, got {sched_ts}")
        if self.horizon <= 0:
            raise ValueError(f"scenario {self.name!r}: horizon must be > 0")

    # ------------------------------------------------------------- introspect
    @property
    def n_classes(self) -> int:
        return len(self.profiles)

    @property
    def class_names(self) -> tuple:
        return tuple(p.name for p in self.profiles)

    def shares_at(self, t: float) -> np.ndarray:
        """Normalized class shares in effect at time ``t`` (the latest
        schedule entry with ``t_k <= t``; profile shares before any)."""
        shares = np.array([p.share for p in self.profiles], dtype=float)
        best = -np.inf
        for t_k, s_k in self.mix_schedule:
            if best < t_k <= t:
                best = t_k
                shares = np.array(s_k, dtype=float)
        return shares / shares.sum()

    def failure_events(self, n: Optional[int] = None) -> list:
        """Capacity script in ``ClusterEngine.run(failure_events=...)``
        format, server ids clamped to cluster size ``n``."""
        return [ev.as_tuple(n) for ev in self.capacity_events]

    def expected_rates(self, horizon: Optional[float] = None) -> np.ndarray:
        """Per-class time-averaged arrival rates (planner cold-start
        inputs; cluster level, requests/second)."""
        h = self.horizon if horizon is None else horizon
        # average the (deterministic) share path on a coarse grid
        ts = np.linspace(0.0, h, 65)[:-1]
        shares = np.stack([self.shares_at(float(t)) for t in ts]).mean(0)
        return self.arrivals.mean_rate(h) * shares

    # --------------------------------------------------------------- generate
    def generate(self, seed: Optional[int] = None,
                 horizon: Optional[float] = None,
                 compression: float = 1.0,
                 rate_scale: float = 1.0) -> list:
        """Sample one validated request trace.

        ``compression`` follows :class:`repro_torch.data.traces.TraceConfig`
        (divide interarrival times by ``1/compression``, i.e. scale the
        offered load by ``1/compression``); ``rate_scale`` multiplies the
        intensity directly.  Both leave authored schedule landmarks
        (rate-shift times, capacity events) on the output time axis --
        see the :mod:`repro_torch.workloads.arrivals` module doc.
        """
        if compression <= 0 or rate_scale <= 0:
            raise ValueError("compression and rate_scale must be positive")
        h = self.horizon if horizon is None else float(horizon)
        factor = rate_scale / compression
        proc = self.arrivals if factor == 1.0 else self.arrivals.scaled(factor)
        rng = np.random.default_rng(self.seed if seed is None else seed)
        times = proc.sample(rng, h)
        reqs = []
        for rid, t in enumerate(times):
            i = int(rng.choice(self.n_classes, p=self.shares_at(float(t))))
            p = self.profiles[i]
            P, D = sample_lengths(rng, p)
            reqs.append(Request(rid, float(t), i, P, D, patience=p.patience))
        validate_requests(reqs, source=f"scenario:{self.name}")
        return reqs

    def tensorize(self, seed: Optional[int] = None,
                  horizon: Optional[float] = None,
                  compression: float = 1.0, rate_scale: float = 1.0,
                  max_requests: Optional[int] = None,
                  pad_to: Optional[int] = None) -> TraceTensors:
        """``tensorize_trace(generate(...))`` -- batched-engine input."""
        return tensorize_trace(
            self.generate(seed=seed, horizon=horizon,
                          compression=compression, rate_scale=rate_scale),
            max_requests=max_requests, pad_to=pad_to)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register_scenario(s: Scenario, overwrite: bool = False) -> Scenario:
    """Add a scenario to the registry (``overwrite=False`` protects the
    built-ins from accidental shadowing).  Returns ``s`` for chaining."""
    if s.name in _REGISTRY and not overwrite:
        raise ScenarioError(f"scenario {s.name!r} already registered")
    _REGISTRY[s.name] = s
    return s


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ScenarioError(
            f"unknown scenario {name!r}; available: {list_scenarios()}"
        ) from None


def list_scenarios() -> list:
    """Sorted names of every registered scenario."""
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-in catalog (documented in docs/WORKLOADS.md; tools/check_docs.py
# cross-checks the doc table against this registry)
# ---------------------------------------------------------------------------

# The Azure-like two-class marginals the repo has always synthesized
# (TraceConfig defaults); kept verbatim so the benchmarks that replayed
# hand-rolled TraceConfig blocks can point here instead.
_AZURE_2023_PROFILES = (
    ClassProfile("code", mean_prompt=2048, mean_decode=36,
                 cv_prompt=1.2, cv_decode=1.5, share=0.45),
    ClassProfile("conversation", mean_prompt=1020, mean_decode=211,
                 cv_prompt=1.4, cv_decode=1.1, share=0.55),
)
_AZURE_2024_PROFILES = (
    ClassProfile("code", mean_prompt=3200, mean_decode=25,
                 cv_prompt=1.1, cv_decode=1.3, share=0.35),
    ClassProfile("conversation", mean_prompt=810, mean_decode=320,
                 cv_prompt=1.5, cv_decode=1.2, share=0.65),
)
_AZURE_MMPP = MMPPArrivals(base_rate=2.0, levels=(0.55, 1.9),
                           switch=(1 / 45.0, 1 / 25.0))


def _dolly_profiles():
    from repro_torch.data.traces import DOLLY_STATS

    picks = (("brainstorming", 0.25), ("closed_qa", 0.3),
             ("summarization", 0.2), ("general_qa", 0.25))
    return tuple(
        ClassProfile(n, mean_prompt=DOLLY_STATS[n][0],
                     mean_decode=DOLLY_STATS[n][1], cv_prompt=0.8,
                     cv_decode=0.9, share=s, patience=90.0)
        for n, s in picks)


_BUILTINS = (
    Scenario(
        name="azure_2023",
        description="Azure-like 2023 slice: code + conversation marginals, "
                    "two-state MMPP bursts (the repo's classic TraceConfig).",
        profiles=_AZURE_2023_PROFILES,
        arrivals=_AZURE_MMPP,
        horizon=300.0,
        seed=42,
        tags=("stationary", "bursty", "azure"),
    ),
    Scenario(
        name="azure_2024",
        description="Azure-like 2024 slice: heavier conversation share, "
                    "longer outputs.",
        profiles=_AZURE_2024_PROFILES,
        arrivals=_AZURE_MMPP,
        horizon=300.0,
        seed=24,
        tags=("stationary", "bursty", "azure"),
    ),
    Scenario(
        name="conv_latent",
        description="EC.8.4 latent-mixture instance: 'conversation' is "
                    "secretly chat + analysis with opposite P/D profiles "
                    "(the workload-classification benchmark's generator).",
        profiles=(
            ClassProfile("code", mean_prompt=2048, mean_decode=36,
                         cv_prompt=1.2, cv_decode=1.5, share=0.385),
            ClassProfile("conv-chat", mean_prompt=200, mean_decode=900,
                         cv_prompt=0.6, cv_decode=0.8, share=0.462),
            ClassProfile("conv-analysis", mean_prompt=2600, mean_decode=30,
                         cv_prompt=0.6, cv_decode=0.8, share=0.153),
        ),
        arrivals=_AZURE_MMPP,
        horizon=300.0,
        seed=42,
        tags=("stationary", "bursty", "latent-classes"),
    ),
    Scenario(
        name="dolly_mix",
        description="Four Dolly-15k task categories (EC Table 4 means) "
                    "under homogeneous Poisson arrivals with finite "
                    "patience, so expiry/abandonment paths fire.",
        profiles=_dolly_profiles(),
        arrivals=PoissonArrivals(rate=20.0),
        horizon=240.0,
        seed=1,
        tags=("stationary", "deadline"),
    ),
    Scenario(
        name="agentic_loops",
        description="Agentic tool-use traffic: many short-prompt/short-"
                    "decode tool steps punctuated by long planning turns, "
                    "with a 3-regime MMPP (idle / steady / tool-storm).",
        profiles=(
            ClassProfile("tool_step", mean_prompt=600, mean_decode=90,
                         cv_prompt=0.9, cv_decode=1.1, share=0.7,
                         patience=45.0),
            ClassProfile("plan_turn", mean_prompt=1600, mean_decode=650,
                         cv_prompt=1.0, cv_decode=1.0, share=0.3,
                         patience=120.0),
        ),
        arrivals=MMPPArrivals(base_rate=16.0, levels=(0.3, 1.0, 2.6),
                              switch=(1 / 30.0, 1 / 40.0, 1 / 15.0)),
        horizon=240.0,
        seed=5,
        tags=("bursty", "agentic", "deadline"),
    ),
    Scenario(
        name="rag_heavy",
        description="Retrieval-augmented mix: huge stuffed-context "
                    "prompts with short answers next to ordinary chat "
                    "(prefill-dominated contention).",
        profiles=(
            ClassProfile("rag_query", mean_prompt=6000, mean_decode=120,
                         cv_prompt=0.7, cv_decode=0.9, share=0.4),
            ClassProfile("chat", mean_prompt=500, mean_decode=260,
                         cv_prompt=1.2, cv_decode=1.0, share=0.6),
        ),
        arrivals=PoissonArrivals(rate=14.0),
        horizon=240.0,
        seed=11,
        tags=("stationary", "prefill-heavy", "rag"),
    ),
    Scenario(
        name="reasoning_long",
        description="Reasoning-model traffic: short prompts, very long "
                    "chains of thought (decode-dominated contention).",
        profiles=(
            ClassProfile("reasoning", mean_prompt=350, mean_decode=2400,
                         cv_prompt=0.8, cv_decode=0.6, share=0.35),
            ClassProfile("chat", mean_prompt=700, mean_decode=220,
                         cv_prompt=1.2, cv_decode=1.0, share=0.65),
        ),
        arrivals=PoissonArrivals(rate=10.0),
        horizon=240.0,
        seed=13,
        tags=("stationary", "decode-heavy", "reasoning"),
    ),
    Scenario(
        name="diurnal",
        description="Piecewise-constant diurnal curve (one simulated "
                    "'day' of 240 s, amplitude 0.6) over the Azure 2023 "
                    "marginals.",
        profiles=_AZURE_2023_PROFILES,
        arrivals=diurnal(base_rate=18.0, amplitude=0.6, period=240.0,
                         horizon=480.0, n_bins=16),
        horizon=480.0,
        seed=3,
        tags=("nonstationary", "diurnal"),
    ),
    Scenario(
        name="flash_crowd",
        description="Flash crowd: 5x arrival spike on [100, 140) s over "
                    "otherwise steady Azure 2023 traffic.",
        profiles=_AZURE_2023_PROFILES,
        arrivals=flash_crowd(base_rate=14.0, spike_mult=5.0,
                             t_on=100.0, t_off=140.0),
        horizon=300.0,
        seed=7,
        tags=("nonstationary", "adversarial", "spike"),
    ),
    Scenario(
        name="rate_shift",
        description="Regime change at t = 120 s: arrival rate steps "
                    "2.5x and the mix flips from code-heavy to "
                    "conversation-heavy -- the online controller's "
                    "showcase (Section 6.2).",
        profiles=(
            ClassProfile("code", mean_prompt=2048, mean_decode=36,
                         cv_prompt=1.2, cv_decode=1.5, share=0.8),
            ClassProfile("conversation", mean_prompt=1020, mean_decode=211,
                         cv_prompt=1.4, cv_decode=1.1, share=0.2),
        ),
        arrivals=rate_shift(rate0=12.0, rate1=30.0, t_shift=120.0),
        mix_schedule=((120.0, (0.25, 0.75)),),
        horizon=300.0,
        seed=9,
        tags=("nonstationary", "adversarial", "rate-shift"),
    ),
    Scenario(
        name="capacity_churn",
        description="Server churn under steady load: two failures at "
                    "t = 60 s, staggered recovery, one straggler -- "
                    "drives OnlineController.set_capacity replans.",
        profiles=_AZURE_2023_PROFILES,
        arrivals=PoissonArrivals(rate=16.0),
        horizon=300.0,
        capacity_events=(
            CapacityEvent(60.0, "fail", 0),
            CapacityEvent(60.0, "fail", 1),
            CapacityEvent(150.0, "recover", 0),
            CapacityEvent(210.0, "recover", 1),
            CapacityEvent(90.0, "straggle", 2, speed=3.0),
            CapacityEvent(180.0, "straggle", 2, speed=1.0),
        ),
        seed=17,
        tags=("nonstationary", "elastic", "failures"),
    ),
    Scenario(
        name="link_degrade",
        description="Interconnect brownout under steady load: three "
                    "servers lose 3/4 of their KV handoff bandwidth on "
                    "[60, 180) s (`degrade` events), then recover -- "
                    "slows prefill->decode transfers without changing "
                    "the server count, so replans are rate-driven.",
        profiles=_AZURE_2023_PROFILES,
        arrivals=PoissonArrivals(rate=16.0),
        horizon=300.0,
        capacity_events=(
            CapacityEvent(60.0, "degrade", 0, speed=0.25),
            CapacityEvent(60.0, "degrade", 1, speed=0.25),
            CapacityEvent(60.0, "degrade", 2, speed=0.25),
            CapacityEvent(180.0, "degrade", 0, speed=1.0),
            CapacityEvent(180.0, "degrade", 1, speed=1.0),
            CapacityEvent(180.0, "degrade", 2, speed=1.0),
        ),
        seed=19,
        tags=("nonstationary", "elastic", "links", "heterogeneity"),
    ),
)

for _s in _BUILTINS:
    register_scenario(_s)
del _s
