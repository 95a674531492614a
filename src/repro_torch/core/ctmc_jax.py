"""Uniformized simulation of the aggregate CTMC, batched over replications.

Same stochastic law as :class:`repro_torch.core.simulator.CTMCSimulator`
-- the paper's aggregate many-server CTMC (Section 2.3) under the
gate-and-route policy family -- re-expressed so the event loop is a
fixed-length loop of structurally identical steps.  A batch of
replications is one call of :func:`repro_torch.kernels.ctmc_scan.ctmc_scan`:
on the card, the CUDA kernel (a warp per replication); on the CPU,
its plain PyTorch version, which holds the step function
(``kernels/ctmc_scan/ops.py::_build_step``).  The module keeps the
reference's name (``repro.core.ctmc_jax``) so that a reader finds its
counterpart.

**Uniformization.**  The exact CTMC jumps at state-dependent total rate
``R(s)``.  Uniformization picks a constant ``Lambda >= sup_s R(s)``, runs a
Poisson(``Lambda``) clock, and at each tick executes a real transition with
probability ``R(s)/Lambda`` (otherwise a self-loop).  The bound:

    Lambda =   n * sum_i lambda_i              (arrivals)
             + M * max_i mu_p,i                (prefills; X_+ <= M)
             + cap_m * max_i mu_m,i            (mixed decodes; Y_m+ <= cap_m)
             + cap_s * max_i mu_s,i            (solo decodes;  Y_s+ <= cap_s)
             + sum_i theta_i * (Qp_cap_i + Qd_cap_i)   (abandonment caps)

where ``cap_m = (B-1) * M`` (0 for prefill-only mixed servers) and
``cap_s = B * (n - M)``.  Abandonment rates are proportional to unbounded
queue lengths, so they are clipped at generous per-class caps; steps on
which a queue exceeds its cap are counted in ``clip_steps``.

**Self-loop skipping (default stepping mode).**  A run of self-loops out
of ``s`` on the ``Lambda`` clock is one Exp(``R(s)``) holding time, so the
default ``stepping="events"`` makes every step a real transition, with the
budget from the pathwise conservation law (at most ``3 A`` events for
``A ~ Poisson(n sum_i lambda_i T)`` arrivals).  ``stepping="ticks"`` runs
the strict ``Lambda``-clock form.  Both stop accounting at the horizon; if
the budget runs out first, ``t_end < horizon`` reports it.

**Precision.**  ``dtype`` (float32 by default, as the reference runs
without ``x64``) sets the type of the clock, the parameters and the
counters.  At n of about 16384 and above the float32 clock's ULP exceeds
the mean time between events and the clock stalls, and the float32 event
counter saturates at 2**24: the optimality-gap study passes float64.

Semantics, policy surface and outputs are the reference's: the occupancy,
priority and FCFS gates; the ``solo_first`` (also for ``immediate`` /
``local_fcfs``) and ``randomized`` routers, with the EC.7 pool weights;
``bundled`` and ``separate`` charging; time-binned probes via
``telemetry=``.  Random numbers come from Philox4x32-10 keyed by the
replication's seed (:func:`repro_torch.compat.prng_key`), not from JAX's
threefry, so the port matches the reference in distribution, not path.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.compat import prng_key, resolve_device
# ``_categorical`` is re-exported for the trace-replay engine, which
# imports it from here as the reference's engine does
from repro_torch.kernels.ctmc_scan.ops import (_categorical, ctmc_scan,  # noqa: F401
                                              pack_block)
from repro_torch.telemetry.probes import extract_probes, resolve_probe_spec

from .policies import FCFSGate, OccupancyGate, PolicySpec, PriorityRatioGate
from .simulator import CTMCResult
from .types import (Pricing, ServicePrimitives, WorkloadClass, rate_arrays,
                    resolve_primitives)

__all__ = [
    "UniformizedCTMC",
    "uniformization_bound",
    "run_uniformized",
    "run_uniformized_batch",
    "run_cells_raw",
]


def _gate_kind(policy: PolicySpec) -> str:
    gate = policy.gate
    if isinstance(gate, OccupancyGate):
        return "occupancy"
    if isinstance(gate, PriorityRatioGate):
        return "priority"
    if isinstance(gate, FCFSGate):
        return "fcfs"
    raise ValueError(
        f"ctmc_jax does not support gate {type(gate).__name__}; "
        "use the Python CTMCSimulator")


def uniformization_bound(classes: Sequence[WorkloadClass],
                         prim: ServicePrimitives, policy: PolicySpec,
                         n: int, cap_margin: float = 6.0,
                         kv_xfer: float = 0.0) -> dict:
    """Static rate bound + abandonment caps for one instance.

    Returns ``{"Lambda", "M", "cap_m", "cap_s", "qp_cap", "qd_cap"}`` as
    plain numpy values (``qp_cap``/``qd_cap`` are per-class arrays, inf
    where ``theta_i == 0`` -- a zero rate needs no cap).
    """
    prim = resolve_primitives(prim)
    arr = rate_arrays(classes, prim, kv_xfer)
    lam_tot = n * arr["lam"]
    theta = arr["theta"]
    M = policy.mixed_target(n)
    B = prim.batch_cap
    cap_m = 0.0 if policy.prefill_only_mixed else float((B - 1) * M)
    cap_s = float(B * (n - M))
    with np.errstate(divide="ignore", invalid="ignore"):
        base = np.where(theta > 0, lam_tot / np.maximum(theta, 1e-300), 0.0)
    cap = np.ceil(cap_margin * base + 20.0 * np.sqrt(base + 1.0) + 100.0)
    qp_cap = np.where(theta > 0, cap, np.inf)
    qd_cap = np.where(theta > 0, cap, np.inf)
    ab = float(np.sum(np.where(theta > 0, theta * cap, 0.0)))
    lam = (float(lam_tot.sum())
           + float(M * arr["mu_p"].max())
           + cap_m * float(arr["mu_m"].max())
           + cap_s * float(arr["mu_s"].max())
           + 2.0 * ab)
    return {"Lambda": lam, "M": float(M), "cap_m": cap_m, "cap_s": cap_s,
            "qp_cap": qp_cap, "qd_cap": qd_cap}


def _keys(keys) -> torch.Tensor:
    return torch.stack([prng_key(k) if isinstance(k, (int, np.integer))
                        else torch.as_tensor(k, dtype=torch.int64).cpu()
                        for k in keys])


def run_uniformized_batch(params, keys, *, n_steps, gate_kind, router_kind,
                          charging, has_pw, stepping, telemetry=None) -> dict:
    """Every replication of one instance in one call: ``keys`` (R, 2)
    generator keys (or int seeds); leaves gain a leading replication
    axis."""
    statics = dict(n_steps=n_steps, gate_kind=gate_kind,
                   router_kind=router_kind, charging=charging, has_pw=has_pw,
                   stepping=stepping)
    fp, ip = pack_block(params, statics, _keys(keys))
    spec = resolve_probe_spec(telemetry)
    return ctmc_scan(fp, ip, n_classes=params["lam_tot"].shape[0],
                     n_bins=spec.n_bins if spec is not None else 0)


def run_uniformized(params, key, **statics) -> dict:
    """One replication; returns the raw carry (tensors)."""
    raw = run_uniformized_batch(params, [key], **statics)
    return {k: v[0] for k, v in raw.items()}


def run_cells_raw(cells: Sequence[tuple]) -> list:
    """Replications of several instances in ONE call of the kernel.

    ``cells`` is a sequence of ``(sim, seeds)`` with ``sim`` a
    :class:`UniformizedCTMC`; every ``sim`` needs the same class count,
    dtype, device and telemetry setting.  Each replication runs on its own
    cell's parameters and step budget.  Returns one raw carry per cell, as
    :meth:`UniformizedCTMC.run_batch_raw` would."""
    sims = [s for s, _ in cells]
    first = sims[0]
    for s in sims[1:]:
        if (s.I, s.dtype, s.device, s.telemetry) != (
                first.I, first.dtype, first.device, first.telemetry):
            raise ValueError("run_cells_raw needs one class count, dtype, "
                             "device and telemetry setting across cells")
    blocks = [pack_block(s.params, s._static, _keys(seeds))
              for s, seeds in cells]
    fp = torch.cat([b[0] for b in blocks])
    ip = torch.cat([b[1] for b in blocks])
    spec = first.telemetry
    raw = ctmc_scan(fp, ip, n_classes=first.I,
                    n_bins=spec.n_bins if spec is not None else 0)
    out, r0 = [], 0
    for (_, seeds) in cells:
        r1 = r0 + len(seeds)
        out.append({k: v[r0:r1] for k, v in raw.items()})
        r0 = r1
    return out


class UniformizedCTMC:
    """Batched uniformized simulator of the aggregate CTMC.

    Drop-in statistical replacement for :class:`CTMCSimulator` on the
    gate-and-route family: same classes/primitives/pricing/policy inputs,
    same :class:`CTMCResult` outputs, but replications run as one batch.
    ``horizon`` and ``warmup`` are fixed at construction because the step
    budget (``n_steps ~ Lambda * horizon``) depends on them.

    ``stepping`` picks the step form: ``"events"`` (default) runs one real
    transition per step with the conservation-law event budget
    (~``3 n lambda T`` steps); ``"ticks"`` runs the strict Lambda-clock
    uniformization (~``Lambda * T`` steps, self-loops included).
    ``cap_margin`` scales the abandonment-rate caps of the ticks-mode
    bound; ``steps_margin`` adds Poisson slack to the step count so the
    loop covers the horizon with overwhelming probability (check
    ``t_end == horizon`` on the result).  ``dtype`` is the type of the
    clock, parameters and counters; ``device`` defaults to the card.
    """

    def __init__(self, classes: Sequence[WorkloadClass],
                 prim: ServicePrimitives, pricing: Pricing,
                 policy: PolicySpec, n: int, horizon: float,
                 warmup: float = 0.0, *, stepping: str = "events",
                 cap_margin: float = 6.0, steps_margin: float = 6.0,
                 n_steps: int | None = None, telemetry=None,
                 kv_xfer: float = 0.0, dtype=torch.float32, device=None):
        self.classes = tuple(classes)
        self.policy = policy
        self.n = int(n)
        self.I = len(self.classes)
        self.horizon = float(horizon)
        self.warmup = float(warmup)
        self.dtype = dtype
        self.device = resolve_device(device)

        if stepping not in ("events", "ticks"):
            raise ValueError(
                f"stepping must be events|ticks, got {stepping!r}")
        self.stepping = stepping

        arr = rate_arrays(self.classes, prim, kv_xfer)
        bound = uniformization_bound(self.classes, prim, policy, self.n,
                                     cap_margin=cap_margin,
                                     kv_xfer=kv_xfer)
        self.Lambda = bound["Lambda"]
        self.M = int(bound["M"])
        if n_steps is not None:
            self.n_steps = int(n_steps)
        elif stepping == "ticks":
            lt = self.Lambda * self.horizon
            self.n_steps = int(math.ceil(
                lt + steps_margin * math.sqrt(lt) + 64))
        else:
            # pathwise: events <= 3 * arrivals, arrivals ~ Poisson(n lam T)
            at = float(self.n * arr["lam"].sum()) * self.horizon
            self.n_steps = int(math.ceil(
                3.0 * (at + steps_margin * math.sqrt(at)) + 64))

        self.gate_kind = _gate_kind(policy)
        self.router_kind = ("randomized" if policy.router == "randomized"
                            else "solo_first")
        self.charging = policy.charging
        pw_m, pw_s = policy.pool_weights_mixed, policy.pool_weights_solo
        if (pw_m is None) != (pw_s is None):
            raise ValueError("ctmc_jax needs both pool-weight vectors "
                             "or neither")
        self.has_pw = pw_m is not None

        ones = np.ones(self.I)

        def a(v):
            return torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   dtype=dtype).to(self.device)

        gate = policy.gate
        self.params = {
            "lam_tot": a(self.n * arr["lam"]),
            "theta": a(arr["theta"]),
            "mu_p": a(arr["mu_p"]),
            "mu_m": a(arr["mu_m"]),
            "mu_s": a(arr["mu_s"]),
            "w": a([pricing.bundled_reward(c) for c in self.classes]),
            "w_pre": a([pricing.prefill_reward(c) for c in self.classes]),
            "w_dec": a([pricing.decode_reward(c) for c in self.classes]),
            "x_star": a(gate.x_star if isinstance(gate, OccupancyGate)
                        else ones),
            "qp_star": a(gate.qp_star if isinstance(gate, OccupancyGate)
                         else 0 * ones),
            "ratio": a(gate.ratio if isinstance(gate, PriorityRatioGate)
                       else ones),
            "p_s": a(policy.solo_prob if policy.solo_prob is not None
                     else ones),
            "pw_m": a(pw_m if pw_m is not None else ones),
            "pw_s": a(pw_s if pw_s is not None else ones),
            "n": a(self.n),
            "M": a(self.M),
            "cap_m": a(bound["cap_m"]),
            "cap_s": a(bound["cap_s"]),
            "qp_cap": a(bound["qp_cap"]),
            "qd_cap": a(bound["qd_cap"]),
            "Lambda": a(self.Lambda),
            "horizon": a(self.horizon),
            "warmup": a(self.warmup),
        }
        self.telemetry = resolve_probe_spec(telemetry)
        self._static = dict(n_steps=self.n_steps, gate_kind=self.gate_kind,
                            router_kind=self.router_kind,
                            charging=self.charging, has_pw=self.has_pw,
                            stepping=self.stepping,
                            telemetry=self.telemetry)

    # -- raw (tensor) interface ---------------------------------------------
    def run_raw(self, seed) -> dict:
        """One replication; returns the raw carry (tensors)."""
        return run_uniformized(self.params, seed, **self._static)

    def run_batch_raw(self, seeds: Sequence, *,
                      placement: str = "vmap") -> dict:
        """All replications in one batch; leaves gain a leading
        replication axis.

        ``placement``: ``"vmap"`` (default) runs the batch as one call;
        ``"shard_map"``, the reference's partition over a device mesh,
        comes with the sweep layer (ROADMAP A8) and raises until then.
        """
        if placement == "vmap":
            return run_uniformized_batch(self.params, list(seeds),
                                         **self._static)
        if placement == "shard_map":
            raise NotImplementedError(
                "placement='shard_map' needs sweep/sharded.py, which is not "
                "ported yet (ROADMAP A8); use 'vmap'")
        raise ValueError(f"unknown placement {placement!r} (expected "
                         f"vmap|shard_map)")

    def telemetry_from_raw(self, raw: dict) -> dict:
        """Host-side probe report (:func:`extract_probes`) from a raw
        carry of a telemetry-enabled run.  The aggregate chain fills the
        trajectory probes only -- per-request latency histograms do not
        exist at the class-aggregate level."""
        if self.telemetry is None:
            raise ValueError("this UniformizedCTMC was built without "
                             "telemetry=; pass a ProbeSpec/True at init")
        host = {k: v.cpu().numpy() for k, v in raw.items()}
        return extract_probes(host, self.telemetry, horizon=self.horizon,
                              n_servers=self.n)

    # -- CTMCResult interface ----------------------------------------------
    def _to_result(self, o: dict) -> CTMCResult:
        meas = max(float(o["acc_t"]), 1e-12)
        n = self.n
        return CTMCResult(
            t_end=float(o["t"]),
            revenue=float(o["rev"]),
            revenue_rate_per_server=float(o["rev"]) / (n * meas),
            completions=np.asarray(o["completions"], dtype=np.float64),
            arrivals=np.asarray(o["arrivals"], dtype=np.float64),
            abandons_p=np.asarray(o["ab_p"], dtype=np.float64),
            abandons_d=np.asarray(o["ab_d"], dtype=np.float64),
            avg_x=np.asarray(o["acc_x"]) / meas / n,
            avg_ym=np.asarray(o["acc_ym"]) / meas / n,
            avg_ys=np.asarray(o["acc_ys"]) / meas / n,
            avg_qp=np.asarray(o["acc_qp"]) / meas / n,
            avg_qd=np.asarray(o["acc_qd"]) / meas / n,
            n_events=int(o["n_events"]),
        )

    def results_from_raw(self, raw: dict) -> list:
        """Split a :meth:`run_batch_raw` carry into per-replication
        :class:`CTMCResult` objects."""
        host = {k: v.cpu().numpy() for k, v in raw.items()}
        reps = host["t"].shape[0]
        return [self._to_result({k: v[r] for k, v in host.items()})
                for r in range(reps)]

    def run(self, seed) -> CTMCResult:
        return self._to_result({k: v.cpu().numpy()
                                for k, v in self.run_raw(seed).items()})

    def run_batch(self, seeds: Sequence, *, placement: str = "vmap") -> list:
        return self.results_from_raw(
            self.run_batch_raw(seeds, placement=placement))
