"""Workload traces: Azure-like synthesis and CSV replay.

The Azure LLM inference traces released with Splitwise (2023) and DynamoLLM
(2024) are not redistributable in this offline container, so we provide a
generator that matches their published *marginal* statistics: two native
classes (``code``, ``conversation``) with lognormal prompt/output lengths and
bursty arrivals from a two-state Markov-modulated Poisson process (MMPP).
``load_trace_csv`` replays a real trace file (columns: t, class, P, D) when one
is available, so all benchmarks accept either source.

Interarrival-time compression (the paper's load-scaling device, Section 6.2)
is a parameter of both paths.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

__all__ = ["Request", "ClassProfile", "TraceConfig", "TraceValidationError",
           "TraceTensors", "synth_azure_trace", "load_trace_csv",
           "validate_requests", "tensorize_trace", "untensorize_trace",
           "chunk_trace", "concat_chunks",
           "dolly_classes", "DOLLY_STATS", "trace_class_means",
           "trace_class_means_windowed"]


class TraceValidationError(ValueError):
    """A request trace violates the invariants every engine assumes."""


@dataclass
class Request:
    rid: int
    t_arrival: float
    cls: int
    prompt_len: int
    decode_len: int
    patience: float = float("inf")  # absolute deadline length (seconds)


@dataclass(frozen=True)
class ClassProfile:
    """Marginal statistics of one synthetic request class.

    ``patience`` is the absolute per-request deadline in seconds
    (:attr:`Request.patience`; ``inf`` = never expires), mirroring the
    ``patience`` argument of :func:`dolly_classes` so synthetic traces
    can exercise the SLI/expiry paths too.
    """

    name: str
    mean_prompt: float
    mean_decode: float
    cv_prompt: float = 1.0  # lognormal coefficient of variation
    cv_decode: float = 1.0
    share: float = 0.5  # fraction of traffic
    patience: float = float("inf")  # per-request deadline (seconds)


#: Published task-category means from the Dolly-15k table (paper Table EC.4).
DOLLY_STATS = {
    "brainstorming": (61, 331),
    "classification": (123, 142),
    "closed_qa": (992, 182),
    "creative_writing": (89, 915),
    "general_qa": (69, 572),
    "information_extraction": (1139, 273),
    "open_qa": (45, 293),
    "summarization": (1177, 436),
}


@dataclass(frozen=True)
class TraceConfig:
    """Azure-like two-class trace (code + conversation)."""

    horizon: float = 600.0  # seconds of (compressed) trace
    base_rate: float = 2.0  # total requests/second before compression
    compression: float = 1.0  # divide interarrival times by 1/compression<1
    profiles: tuple = (
        ClassProfile("code", mean_prompt=2048, mean_decode=36,
                     cv_prompt=1.2, cv_decode=1.5, share=0.45),
        ClassProfile("conversation", mean_prompt=1020, mean_decode=211,
                     cv_prompt=1.4, cv_decode=1.1, share=0.55),
    )
    # MMPP burstiness: rate multipliers and switching rates between regimes.
    mmpp_levels: tuple = (0.55, 1.9)
    mmpp_switch: tuple = (1 / 45.0, 1 / 25.0)
    seed: int = 42


def _lognormal(rng, mean, cv, size=None):
    sigma2 = np.log(1 + cv * cv)
    mu = np.log(mean) - sigma2 / 2
    return rng.lognormal(mu, np.sqrt(sigma2), size=size)


def sample_lengths(rng, profile: ClassProfile) -> tuple:
    """Draw one (P, D) pair from a profile's lognormal marginals.

    Shared by :func:`synth_azure_trace` and the scenario generators in
    :mod:`repro_torch.workloads`; the floors (8 prompt / 2 decode tokens) keep
    degenerate draws out of the engines.
    """
    P = max(8, int(_lognormal(rng, profile.mean_prompt, profile.cv_prompt)))
    D = max(2, int(_lognormal(rng, profile.mean_decode, profile.cv_decode)))
    return P, D


def validate_requests(reqs: Sequence[Request],
                      source: str = "trace") -> Sequence[Request]:
    """Shared validation behind every trace source (and tensorization).

    Both engines assume arrival times are finite, nonnegative and
    nondecreasing, and token lengths strictly positive; a violation used
    to surface only as downstream NaNs (empty metrics, silent zero
    revenue).  Raises :class:`TraceValidationError` naming the offending
    request instead.  Returns ``reqs`` unchanged so call sites can chain.
    """
    t_prev = 0.0
    for k, r in enumerate(reqs):
        if not np.isfinite(r.t_arrival) or r.t_arrival < 0:
            raise TraceValidationError(
                f"{source}: request {r.rid} (index {k}) has non-finite or "
                f"negative arrival time {r.t_arrival!r}")
        if r.t_arrival < t_prev:
            raise TraceValidationError(
                f"{source}: arrival times must be nondecreasing, but "
                f"request {r.rid} (index {k}) arrives at {r.t_arrival} "
                f"after one at {t_prev}")
        t_prev = r.t_arrival
        if not r.prompt_len >= 1 or not r.decode_len >= 1:
            raise TraceValidationError(
                f"{source}: request {r.rid} (index {k}) has non-positive "
                f"token lengths P={r.prompt_len}, D={r.decode_len}")
        if not r.patience > 0:  # NaN fails this too
            raise TraceValidationError(
                f"{source}: request {r.rid} (index {k}) has non-positive "
                f"patience {r.patience!r} (use inf for no deadline)")
        if r.cls < 0:
            raise TraceValidationError(
                f"{source}: request {r.rid} (index {k}) has negative "
                f"class {r.cls}")
    return reqs


def synth_azure_trace(cfg: TraceConfig = TraceConfig()) -> list[Request]:
    """Generate a bursty multiclass trace; timestamps already compressed."""
    rng = np.random.default_rng(cfg.seed)
    shares = np.array([p.share for p in cfg.profiles], dtype=float)
    shares /= shares.sum()
    reqs: list[Request] = []
    t = 0.0
    regime = 0
    # Draw next MMPP switch time.
    t_switch = rng.exponential(1.0 / cfg.mmpp_switch[regime])
    rid = 0
    horizon_raw = cfg.horizon / cfg.compression
    while t < horizon_raw:
        rate = cfg.base_rate * cfg.mmpp_levels[regime]
        dt = rng.exponential(1.0 / rate)
        if t + dt > t_switch:
            t = t_switch
            regime = 1 - regime
            t_switch = t + rng.exponential(1.0 / cfg.mmpp_switch[regime])
            continue
        t += dt
        i = int(rng.choice(len(cfg.profiles), p=shares))
        p = cfg.profiles[i]
        P, D = sample_lengths(rng, p)
        reqs.append(Request(rid, t * cfg.compression, i, P, D,
                            patience=p.patience))
        rid += 1
    validate_requests(reqs, source="synth_azure_trace")
    return reqs


def load_trace_csv(path: str, compression: float = 1.0,
                   class_names: Optional[Sequence[str]] = None) -> list[Request]:
    """Replay a real trace CSV with columns (t, class, P, D) and an
    optional ``patience`` column (deadline seconds; absent/empty =
    ``inf``, matching the ``repro_torch.workloads`` CSV export)."""
    out: list[Request] = []
    name_to_idx: dict[str, int] = (
        {n: k for k, n in enumerate(class_names)} if class_names else {}
    )
    with open(path) as f:
        for rid, row in enumerate(csv.DictReader(f)):
            cname = row.get("class", "0")
            if cname not in name_to_idx and not cname.isdigit():
                name_to_idx.setdefault(cname, len(name_to_idx))
            cls = int(cname) if cname.isdigit() else name_to_idx[cname]
            out.append(
                Request(
                    rid,
                    float(row["t"]) * compression,
                    cls,
                    int(float(row["P"])),
                    int(float(row["D"])),
                    patience=float(row.get("patience") or "inf"),
                )
            )
    out.sort(key=lambda r: r.t_arrival)
    validate_requests(out, source=f"load_trace_csv({path})")
    return out


# ---------------------------------------------------------------------------
# Tensorization (the JAX trace-replay engine's input format)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceTensors:
    """A trace as padded, fixed-shape arrays (``engine_jax`` input).

    All arrays share the padded length ``R``; rows with ``valid == False``
    are padding (``t`` is ``+inf`` there so masked time-minima ignore
    them).  ``rid`` is always ``arange(R)`` for the first ``n_real`` rows:
    tensorization re-ids requests in arrival order, which is what makes
    per-class FCFS a masked ``argmin`` over ``rid``.  ``n_dropped`` counts
    requests cut by the ``max_requests`` cap (never silent: the engine
    surfaces it as a diagnostic).
    """

    rid: np.ndarray        # (R,) int32, arange
    t: np.ndarray          # (R,) float64 arrival times, +inf on padding
    cls: np.ndarray        # (R,) int32
    P: np.ndarray          # (R,) int32 prompt tokens (1 on padding)
    D: np.ndarray          # (R,) int32 decode tokens (1 on padding)
    patience: np.ndarray   # (R,) float64 deadlines (inf = none)
    valid: np.ndarray      # (R,) bool
    n_real: int
    n_dropped: int = 0

    @property
    def R(self) -> int:
        return int(self.rid.shape[0])

    @property
    def n_classes(self) -> int:
        m = self.cls[self.valid]
        return int(m.max()) + 1 if m.size else 1


def tensorize_trace(reqs: Sequence[Request],
                    max_requests: Optional[int] = None,
                    pad_to: Optional[int] = None) -> TraceTensors:
    """Pack a request list into padded arrays for the JAX engine.

    ``max_requests`` caps the number of (earliest-arriving) requests kept;
    the overflow count is recorded in ``n_dropped`` rather than silently
    shifting load.  ``pad_to`` pads the arrays up to a fixed length so
    traces of different sizes share one compiled scan (must be >= the
    kept length).  Requests are validated (:func:`validate_requests`) and
    re-numbered ``0..len-1`` in arrival order.
    """
    reqs = list(validate_requests(reqs, source="tensorize_trace"))
    n_dropped = 0
    if max_requests is not None and len(reqs) > max_requests:
        n_dropped = len(reqs) - int(max_requests)
        reqs = reqs[: int(max_requests)]
    n_real = len(reqs)
    R = max(n_real, 1) if pad_to is None else int(pad_to)
    if R < n_real:
        raise TraceValidationError(
            f"pad_to={R} is smaller than the kept trace length {n_real}")
    t = np.full(R, np.inf, dtype=np.float64)
    cls = np.zeros(R, dtype=np.int32)
    P = np.ones(R, dtype=np.int32)
    D = np.ones(R, dtype=np.int32)
    pat = np.full(R, np.inf, dtype=np.float64)
    valid = np.zeros(R, dtype=bool)
    for k, r in enumerate(reqs):
        t[k] = r.t_arrival
        cls[k] = r.cls
        P[k] = int(r.prompt_len)
        D[k] = int(r.decode_len)
        pat[k] = r.patience
        valid[k] = True
    return TraceTensors(rid=np.arange(R, dtype=np.int32), t=t, cls=cls,
                        P=P, D=D, patience=pat, valid=valid,
                        n_real=n_real, n_dropped=n_dropped)


def untensorize_trace(tt: TraceTensors) -> list[Request]:
    """Inverse of :func:`tensorize_trace` (padding rows dropped).

    Round-trips everything except the original ``rid`` labels, which
    tensorization canonicalises to arrival order (the property tests pin
    this contract down).
    """
    return [
        Request(int(tt.rid[k]), float(tt.t[k]), int(tt.cls[k]),
                int(tt.P[k]), int(tt.D[k]), float(tt.patience[k]))
        for k in range(tt.R) if tt.valid[k]
    ]


def chunk_trace(reqs: Sequence[Request],
                chunk_size: int) -> list[TraceTensors]:
    """Split a trace into fixed-shape chunks for streamed replay.

    Every chunk is padded to exactly ``chunk_size`` rows so they all
    share one compiled step function (the streaming engine splices them
    into its working set one at a time instead of materialising a
    single ``(R,)`` table for the whole trace).  Chunks keep arrival
    order; ``concat_chunks`` is the inverse.  An empty trace yields one
    all-padding chunk so callers never special-case zero requests.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    reqs = list(validate_requests(reqs, source="chunk_trace"))
    if not reqs:
        return [tensorize_trace([], pad_to=chunk_size)]
    return [tensorize_trace(reqs[k:k + chunk_size], pad_to=chunk_size)
            for k in range(0, len(reqs), chunk_size)]


def concat_chunks(chunks: Sequence[TraceTensors]) -> TraceTensors:
    """Reassemble ``chunk_trace`` output into one padded trace.

    Validates the chunk *seams*: the first real arrival of each chunk
    must not precede the last real arrival of the one before it (the
    streamed replay consumes arrivals in order, so a non-monotone seam
    means the chunks were shuffled or came from different traces) and
    raises :class:`TraceValidationError` otherwise.  Padding rows are
    dropped; requests are re-numbered globally in arrival order.
    """
    if not chunks:
        raise TraceValidationError("concat_chunks: no chunks given")
    t_prev = -np.inf
    reqs: list[Request] = []
    for k, ch in enumerate(chunks):
        if ch.n_real == 0:
            continue
        t_real = ch.t[ch.valid]
        if t_real[0] < t_prev:
            raise TraceValidationError(
                f"concat_chunks: chunk {k} starts at t={t_real[0]} before "
                f"the previous chunk's last arrival t={t_prev} -- chunks "
                f"are out of order or from different traces")
        t_prev = float(t_real[-1])
        reqs.extend(untensorize_trace(ch))
    out = tensorize_trace(reqs)
    n_dropped = sum(ch.n_dropped for ch in chunks)
    if n_dropped:
        out = TraceTensors(rid=out.rid, t=out.t, cls=out.cls, P=out.P,
                           D=out.D, patience=out.patience, valid=out.valid,
                           n_real=out.n_real, n_dropped=n_dropped)
    return out


def dolly_classes(names: Sequence[str], total_rate: float, patience: float = 0.0):
    """WorkloadClass list from the published Dolly category means (EC Table 4)."""
    from repro_torch.core.types import WorkloadClass

    share = total_rate / len(names)
    return [
        WorkloadClass(n, DOLLY_STATS[n][0], DOLLY_STATS[n][1], share, patience)
        for n in names
    ]


def trace_class_means(reqs: Sequence[Request], n_classes: int):
    """Empirical per-class (mean P, mean D, rate/sec) -- planner inputs."""
    horizon = max((r.t_arrival for r in reqs), default=0.0) or 1.0
    out = []
    for i in range(n_classes):
        sub = [r for r in reqs if r.cls == i]
        if not sub:
            out.append((1.0, 1.0, 0.0))
            continue
        out.append(
            (
                float(np.mean([r.prompt_len for r in sub])),
                float(np.mean([r.decode_len for r in sub])),
                len(sub) / horizon,
            )
        )
    return out


def trace_class_means_windowed(reqs: Sequence[Request], n_classes: int,
                               window: float):
    """Per-window empirical class statistics of a (nonstationary) trace.

    Splits ``[0, max arrival]`` into consecutive windows of ``window``
    seconds and returns ``[(t0, t1, means), ...]`` where ``means`` has
    the :func:`trace_class_means` layout ``[(mean P, mean D, rate/sec)]``
    computed from the arrivals inside ``[t0, t1)``.  The final window's
    rate is normalized by its *covered* duration (up to the last
    arrival), not the nominal window length, so a trace whose horizon
    is not a multiple of ``window`` does not show a spurious rate drop
    in the last row.  This is the ground-truth counterpart of the
    online controller's rolling-window estimator (Eq. 50): plotting the
    two against each other shows how fast the controller tracks a rate
    shift (see ``examples/online_adaptive.py``).
    """
    if window <= 0:
        raise ValueError("window must be positive")
    horizon = max((r.t_arrival for r in reqs), default=0.0)
    n_win = max(1, int(np.ceil(horizon / window))) if horizon > 0 else 1
    out = []
    for w in range(n_win):
        t0, t1 = w * window, (w + 1) * window
        covered = max(min(t1, horizon) - t0, 1e-9)
        sub = [r for r in reqs if t0 <= r.t_arrival < t1]
        means = []
        for i in range(n_classes):
            cls_sub = [r for r in sub if r.cls == i]
            if not cls_sub:
                means.append((1.0, 1.0, 0.0))
                continue
            means.append(
                (
                    float(np.mean([r.prompt_len for r in cls_sub])),
                    float(np.mean([r.decode_len for r in cls_sub])),
                    len(cls_sub) / covered,
                )
            )
        out.append((t0, t1, means))
    return out
