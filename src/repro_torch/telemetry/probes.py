"""State probes: the reference's ``telemetry/probes``.

:class:`PyProbes` records per-class queue depth, decode occupancy,
prefill chunks in flight, gate admit/drop counters, per-server busy time
and TTFT/E2E latency histograms as time-binned fixed-shape numpy arrays
for the Python engines; :func:`extract_probes` renders them into the
trajectory/SLI report.  The carry probes (:func:`probe_carry`,
:func:`ctmc_probe_carry`, :func:`time_bin`, :func:`wrap_ctmc_step_probes`)
are the same arrays as torch tensors with a leading replication axis,
threaded through the uniformized CTMC's batched step
(:mod:`repro_torch.kernels.ctmc_scan.ops`) and the trace-replay engine's
(:func:`wrap_engine_step_probes`, :mod:`repro_torch.serving.engine_jax`).

Latency histograms use log-spaced bucket edges (:func:`hist_edges`);
percentiles interpolate within the matched bucket, so they are
resolution-limited estimates, not exact order statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

__all__ = [
    "CTMC_PROBE_KEYS",
    "PROBES",
    "ProbeDef",
    "ProbeSpec",
    "PyProbes",
    "extract_probes",
    "hist_attainment",
    "hist_edges",
    "hist_percentile",
    "probe_carry",
    "resolve_probe_spec",
    "time_bin",
    "wrap_ctmc_step_probes",
    "wrap_engine_step_probes",
]


@dataclass(frozen=True)
class ProbeSpec:
    """Probe configuration (frozen, hashable).  ``n_bins`` time bins partition ``[0, horizon]``;
    ``n_hist`` log-spaced latency buckets span
    ``[hist_min, hist_max]`` seconds (under/overflow land in the edge
    buckets)."""

    n_bins: int = 64
    n_hist: int = 32
    hist_min: float = 1e-3
    hist_max: float = 1e3

    def __post_init__(self):
        if self.n_bins < 1 or self.n_hist < 2:
            raise ValueError(
                f"need n_bins >= 1 and n_hist >= 2, got "
                f"{self.n_bins}/{self.n_hist}")
        if not 0 < self.hist_min < self.hist_max:
            raise ValueError(
                f"need 0 < hist_min < hist_max, got "
                f"{self.hist_min}/{self.hist_max}")


def resolve_probe_spec(telemetry) -> Optional[ProbeSpec]:
    """Coerce the ``telemetry`` kwarg every entry point accepts:
    ``None``/``False`` -> off, ``True`` -> default spec, a dict (e.g.
    from ``spec.extra`` JSON) -> ``ProbeSpec(**dict)``, a spec ->
    itself."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return ProbeSpec()
    if isinstance(telemetry, dict):
        return ProbeSpec(**telemetry)
    if isinstance(telemetry, ProbeSpec):
        return telemetry
    raise TypeError(f"telemetry must be None/bool/dict/ProbeSpec, "
                    f"got {type(telemetry).__name__}")


@dataclass(frozen=True)
class ProbeDef:
    """One registered probe: its carry key, shape axes and fill rule."""

    key: str  # carry key ("tlm_" prefix keeps it out of summary paths)
    axes: str  # human-readable shape, e.g. "(n_bins, I)"
    fill: str  # "last" | "sum" | "integral" | "hist"
    description: str


# The probe registry: the single source of truth check_docs.py holds
# docs/OBSERVABILITY.md against (both directions).  Keys are the public
# probe names; ``key`` is the scan-carry array each engine threads.
PROBES: Dict[str, ProbeDef] = {
    "queue_depth": ProbeDef(
        "tlm_q", "(n_bins, I)", "last",
        "per-class prefill-queue depth at the end of each time bin"),
    "decode_occupancy": ProbeDef(
        "tlm_occ", "(n_bins,)", "last",
        "total occupied decode slots at the end of each time bin"),
    "prefill_in_flight": ProbeDef(
        "tlm_pf", "(n_bins,)", "last",
        "servers with an active prefill chunk at the end of each bin"),
    "admits": ProbeDef(
        "tlm_adm", "(n_bins, I)", "sum",
        "per-class gate admissions per bin (queue-head advances; "
        "includes lazily-expired heads when deadline expiry is on)"),
    "drops": ProbeDef(
        "tlm_drop", "(n_bins,)", "sum",
        "abandonments/drops per bin"),
    "events": ProbeDef(
        "tlm_ev", "(n_bins,)", "sum",
        "engine events per bin (arrivals + iteration boundaries)"),
    "busy_seconds": ProbeDef(
        "tlm_busy_bin", "(n_bins,)", "integral",
        "aggregate server-busy seconds per bin (indicator integral, "
        "attributed to the bin each inter-event interval starts in)"),
    "busy_per_server": ProbeDef(
        "tlm_busy_srv", "(n,)", "integral",
        "per-server busy seconds over the whole run "
        "(busy fraction = value / horizon)"),
    "ttft_hist": ProbeDef(
        "tlm_ttft", "(n_hist,)", "hist",
        "time-to-first-token histogram (first decode emission minus "
        "arrival), log-spaced buckets"),
    "e2e_hist": ProbeDef(
        "tlm_e2e", "(n_hist,)", "hist",
        "end-to-end latency histogram (request done minus arrival), "
        "log-spaced buckets"),
}


# trajectory probes the aggregate CTMC engine can also fill (it has no
# per-request identity, so the hist/admit probes do not exist there)
CTMC_PROBE_KEYS = ("tlm_q", "tlm_occ", "tlm_pf", "tlm_drop", "tlm_ev")


def hist_edges(spec: ProbeSpec) -> np.ndarray:
    """The ``n_hist - 1`` log-spaced interior bucket edges (seconds)."""
    return np.geomspace(spec.hist_min, spec.hist_max, spec.n_hist - 1)


def probe_carry(spec: ProbeSpec, *, n: int, I: int, dtype, batch=(),
                device=None) -> dict:
    """Fresh zeroed probe arrays to merge into an engine's carry; each
    gains the leading ``batch`` axes (the replications)."""
    nb, nh = spec.n_bins, spec.n_hist
    b = tuple(batch)

    def z(*shape):
        return torch.zeros(b + shape, dtype=dtype, device=device)

    return {
        "tlm_q": z(nb, I), "tlm_occ": z(nb), "tlm_pf": z(nb),
        "tlm_adm": z(nb, I), "tlm_drop": z(nb), "tlm_ev": z(nb),
        "tlm_busy_bin": z(nb), "tlm_busy_srv": z(n),
        "tlm_ttft": z(nh), "tlm_e2e": z(nh),
    }


def ctmc_probe_carry(spec: ProbeSpec, *, I: int, dtype, batch=(),
                     device=None) -> dict:
    """The trajectory subset for the aggregate CTMC engine (per-request
    histograms do not exist at the class-aggregate level)."""
    full = probe_carry(spec, n=0, I=I, dtype=dtype, batch=batch,
                       device=device)
    return {k: full[k] for k in CTMC_PROBE_KEYS}


def time_bin(t, horizon, n_bins: int, mask):
    """Bin index of time ``t`` in ``[0, horizon]``; masked-off lanes map
    to ``n_bins``, which the carry scatters below drop."""
    width = horizon / n_bins
    b = torch.clamp(torch.floor(t / width), 0, n_bins - 1).to(torch.int32)
    return torch.where(mask, b, n_bins)


def _scatter_drop(arr, b, val, *, add: bool):
    """``arr[r, b[r]] = val[r]`` (or ``+=``) for each replication r, in
    place; a lane with ``b[r] == n_bins`` is dropped (the reference's
    ``.at[b].set/add(..., mode="drop")``)."""
    nb = arr.shape[1]
    keep = (b < nb).view((-1,) + (1,) * (val.dim() - 1))
    r = torch.arange(arr.shape[0], device=arr.device)
    idx = torch.clamp(b, max=nb - 1).long()
    cur = arr[r, idx]
    arr[r, idx] = torch.where(keep, cur + val if add else val, cur)
    return arr


def wrap_engine_step_probes(step, spec: ProbeSpec, params: dict):
    """Post-step probe pass for the trace-replay engine's batched step.

    Wraps the (possibly k-event / fast-forward) step ``step(carry, *args)
    -> carry``, whose tensors carry a leading replication axis: after each
    step, last-value trajectories are scattered into the bin of the new
    clock, counter deltas are added there, and the server-busy indicator
    is integrated over the step's time advance.  Latency histograms need
    no step instrumentation: the engine buckets its ``t_first``/
    ``t_last`` marks once after the loop (the streaming engine folds
    retired rows at each splice).  The probe arrays are updated in place.
    """
    nb = spec.n_bins
    h_eff = params["h_eff"]

    def wrapped(carry, *args):
        t0 = carry["t"]
        busy0 = carry["busy"]
        qhead0 = carry["qhead"]
        ab0 = carry["abandons"]
        ev0 = carry["n_events"]
        c = step(carry, *args)
        dt = c["t"].dtype
        moved = c["n_events"] > ev0
        b = time_bin(c["t"], h_eff, nb, moved)
        _scatter_drop(c["tlm_q"], b, (c["qarr"] - c["qhead"]).to(dt),
                      add=False)
        _scatter_drop(c["tlm_occ"], b, (c["slot_rid"] >= 0).to(dt)
                      .sum((1, 2)), add=False)
        _scatter_drop(c["tlm_pf"], b, (c["pf_rid"] >= 0).to(dt).sum(1),
                      add=False)
        _scatter_drop(c["tlm_adm"], b, (c["qhead"] - qhead0).to(dt),
                      add=True)
        _scatter_drop(c["tlm_drop"], b, c["abandons"] - ab0, add=True)
        _scatter_drop(c["tlm_ev"], b, c["n_events"] - ev0, add=True)
        span = torch.clamp_min(c["t"] - t0, 0.0)
        bs = busy0.to(dt) * span[:, None]
        c["tlm_busy_srv"] = c["tlm_busy_srv"] + bs
        b0 = time_bin(t0, h_eff, nb, moved)
        _scatter_drop(c["tlm_busy_bin"], b0, bs.sum(1), add=True)
        return c

    return wrapped


def wrap_ctmc_step_probes(step, spec: ProbeSpec, horizon):
    """Post-step probe pass for the uniformized-CTMC step (class-aggregate
    state: queue = Q_p, occupancy = Y_m + Y_s, prefills in flight = X).

    ``step(carry, idx) -> (carry, aux)`` works on a batch of replications
    (leading axis); ``horizon`` is a scalar or one per replication.  The
    probe arrays are updated in place."""
    nb = spec.n_bins

    def wrapped(carry, idx):
        ev0 = carry["n_events"]
        ab0 = carry["ab_p"] + carry["ab_d"]
        out, aux = step(carry, idx)
        # the CTMC step rebuilds its carry dict from scratch; re-attach
        # the probe arrays before scattering into them
        out = dict(out)
        for k in CTMC_PROBE_KEYS:
            out[k] = carry[k]
        moved = out["n_events"] > ev0
        b = time_bin(out["t"], horizon, nb, moved)
        _scatter_drop(out["tlm_q"], b, out["qp"], add=False)
        _scatter_drop(out["tlm_occ"], b, (out["ym"] + out["ys"]).sum(-1),
                      add=False)
        _scatter_drop(out["tlm_pf"], b, out["x"].sum(-1), add=False)
        _scatter_drop(out["tlm_drop"], b,
                      (out["ab_p"] + out["ab_d"] - ab0).sum(-1), add=True)
        _scatter_drop(out["tlm_ev"], b, out["n_events"] - ev0, add=True)
        return out, aux

    return wrapped



def _reduce(arr: np.ndarray, tail_ndim: int, how: str) -> np.ndarray:
    """Collapse any leading replication/instance axes: counters and
    histograms sum, last-value/integral trajectories average."""
    arr = np.asarray(arr, dtype=np.float64)
    extra = arr.ndim - tail_ndim
    if extra <= 0:
        return arr
    flat = arr.reshape((-1,) + arr.shape[extra:])
    return flat.sum(axis=0) if how == "sum" else flat.mean(axis=0)


def _ffill(vals: np.ndarray, seen: np.ndarray) -> np.ndarray:
    """Forward-fill empty bins (no event landed there) with the last
    observed value; leading empty bins keep the initial (zero) state."""
    out = np.array(vals, dtype=np.float64)
    last = np.zeros(out.shape[1:] if out.ndim > 1 else ())
    for i in range(out.shape[0]):
        if seen[i]:
            last = out[i]
        else:
            out[i] = last
    return out


def extract_probes(raw: dict, spec: ProbeSpec, *, horizon: float,
                   n_servers: int) -> dict:
    """Host-side probe report from a raw carry (device or numpy).

    Accepts a single-replication carry or a batched one (leading axes
    are reduced: counters/histograms sum, trajectories average over the
    per-replication forward-filled values).  Returns plain numpy arrays
    plus derived SLI percentiles -- everything JSON-serializable via
    ``tolist()``.
    """
    nb = spec.n_bins
    width = horizon / nb

    def tail(key):
        return 2 if key == "tlm_q" or key == "tlm_adm" else 1

    have = {k: np.asarray(raw[k]) for k in
            (d.key for d in PROBES.values()) if k in raw}
    if not have:
        raise KeyError("raw carry holds no tlm_* probe arrays -- was the "
                       "run made with telemetry enabled?")

    # per-replication forward-fill BEFORE averaging the last-value
    # trajectories (an empty bin means "state unchanged", not zero)
    ev_full = np.asarray(have["tlm_ev"], dtype=np.float64)
    flat_ev = ev_full.reshape((-1, nb))

    def ffilled(key):
        arr = np.asarray(have[key], dtype=np.float64)
        flat = arr.reshape((flat_ev.shape[0],) + arr.shape[-(tail(key)):])
        return np.stack([
            _ffill(flat[r], flat_ev[r] > 0)
            for r in range(flat.shape[0])]).mean(axis=0)

    out = {
        "spec": {"n_bins": nb, "n_hist": spec.n_hist,
                 "hist_min": spec.hist_min, "hist_max": spec.hist_max},
        "horizon": float(horizon),
        "bin_width": float(width),
        "t_bins": (np.arange(nb) + 0.5) * width,
        "queue_depth": ffilled("tlm_q"),
        "decode_occupancy": ffilled("tlm_occ"),
        "prefill_in_flight": ffilled("tlm_pf"),
        "events": _reduce(have["tlm_ev"], 1, "sum"),
        "drops": _reduce(have["tlm_drop"], 1, "sum"),
    }
    if "tlm_adm" in have:
        out["admits"] = _reduce(have["tlm_adm"], 2, "sum")
    if "tlm_busy_srv" in have:
        busy = _reduce(have["tlm_busy_srv"], 1, "mean")
        out["busy_per_server"] = busy / max(horizon, 1e-12)
        out["busy_seconds"] = _reduce(have["tlm_busy_bin"], 1, "mean")
        out["busy_fraction"] = (out["busy_seconds"]
                                / (width * max(n_servers, 1)))
    edges = hist_edges(spec)
    out["hist_edges"] = edges
    for name, key in (("ttft", "tlm_ttft"), ("e2e", "tlm_e2e")):
        if key not in have:
            continue
        h = _reduce(have[key], 1, "sum")
        out[f"{name}_hist"] = h
        for q in (50, 95, 99):
            out[f"{name}_p{q}"] = hist_percentile(h, edges, q)
    return out


def hist_percentile(hist: np.ndarray, edges: np.ndarray,
                    q: float) -> float:
    """Percentile estimate from a bucketed histogram: find the bucket
    holding the q-th observation and interpolate linearly inside it
    (edge buckets clamp to their finite edge).  NaN on an empty
    histogram."""
    hist = np.asarray(hist, dtype=np.float64)
    total = hist.sum()
    if total <= 0:
        return float("nan")
    cum = np.cumsum(hist)
    target = q / 100.0 * total
    k = int(np.searchsorted(cum, target, side="left"))
    k = min(k, hist.size - 1)
    lo = edges[k - 1] if k >= 1 else edges[0]
    hi = edges[k] if k < edges.size else edges[-1]
    prev = cum[k - 1] if k >= 1 else 0.0
    frac = 0.0 if hist[k] <= 0 else (target - prev) / hist[k]
    return float(lo + (hi - lo) * np.clip(frac, 0.0, 1.0))


def hist_attainment(hist: np.ndarray, edges: np.ndarray,
                    target_s: float) -> float:
    """Fraction of observations at or below ``target_s`` (conservative:
    a bucket counts only if its upper edge is within the target)."""
    hist = np.asarray(hist, dtype=np.float64)
    total = hist.sum()
    if total <= 0:
        return float("nan")
    upper = np.append(edges, np.inf)
    return float(hist[upper <= target_s].sum() / total)


class PyProbes:
    """Probe collector for the Python engines:
    :class:`repro_torch.serving.engine_sim.ClusterEngine` and
    :class:`repro_torch.core.simulator.CTMCSimulator`.

    Produces the ``tlm_*`` arrays (numpy) under the reference's bin/fill
    semantics, so :func:`extract_probes` renders them identically.
    """

    def __init__(self, spec: ProbeSpec, *, horizon: float, n_servers: int,
                 n_classes: int):
        self.spec = spec
        self.horizon = max(float(horizon), 1e-12)
        self.width = self.horizon / spec.n_bins
        nb, nh = spec.n_bins, spec.n_hist
        self.arr = {
            "tlm_q": np.zeros((nb, n_classes)),
            "tlm_occ": np.zeros(nb),
            "tlm_pf": np.zeros(nb),
            "tlm_adm": np.zeros((nb, n_classes)),
            "tlm_drop": np.zeros(nb),
            "tlm_ev": np.zeros(nb),
            "tlm_busy_bin": np.zeros(nb),
            "tlm_busy_srv": np.zeros(n_servers),
            "tlm_ttft": np.zeros(nh),
            "tlm_e2e": np.zeros(nh),
        }
        self.edges = hist_edges(spec)
        self._t_prev = 0.0
        self._busy_prev = np.zeros(n_servers, dtype=bool)

    def _bin(self, t: float) -> int:
        return int(np.clip(t // self.width, 0, self.spec.n_bins - 1))

    def sample(self, t: float, *, queue_depth, decode_occupancy: float,
               prefill_in_flight: float, busy=None) -> None:
        """Record the post-event state at time ``t`` (last value in the
        bin wins) and integrate the busy indicator since the previous
        sample."""
        b = self._bin(t)
        self.arr["tlm_q"][b] = np.asarray(queue_depth, dtype=float)
        self.arr["tlm_occ"][b] = float(decode_occupancy)
        self.arr["tlm_pf"][b] = float(prefill_in_flight)
        self.arr["tlm_ev"][b] += 1.0
        if busy is not None:
            span = max(t - self._t_prev, 0.0)
            bs = self._busy_prev.astype(float) * span
            self.arr["tlm_busy_srv"] += bs
            self.arr["tlm_busy_bin"][self._bin(self._t_prev)] += bs.sum()
            self._busy_prev = np.asarray(busy, dtype=bool).copy()
        self._t_prev = t

    def count(self, t: float, *, admit_class: Optional[int] = None,
              drops: float = 0.0) -> None:
        b = self._bin(t)
        if admit_class is not None:
            self.arr["tlm_adm"][b, admit_class] += 1.0
        if drops:
            self.arr["tlm_drop"][b] += drops

    def observe_ttft(self, v: float) -> None:
        self.arr["tlm_ttft"][int(np.searchsorted(self.edges, v))] += 1.0

    def observe_e2e(self, v: float) -> None:
        self.arr["tlm_e2e"][int(np.searchsorted(self.edges, v))] += 1.0

    def raw(self) -> dict:
        """The ``tlm_*`` arrays, shaped exactly like the device carry."""
        return dict(self.arr)

    def extract(self) -> dict:
        return extract_probes(self.raw(), self.spec, horizon=self.horizon,
                              n_servers=self.arr["tlm_busy_srv"].size)
