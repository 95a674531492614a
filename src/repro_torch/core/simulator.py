"""Aggregate CTMC simulator of the multiclass many-server network (Section 2.3).

This simulates the paper's stochastic model *exactly* (exponential primitives,
Poisson arrivals, Eqs. (7)-(9)) at the class-aggregate level: with a static
mixed/solo partition, per-server identities are exchangeable, so the Markov
state is (Q_p, X, Q_d(m/s), Y_m, Y_s) per class.  This is the engine behind
the large-n convergence experiments (EC.8.5) and the fluid-limit property
tests; the per-server iteration-level engine lives in
:mod:`repro_torch.serving.engine_sim`.

Semantics notes (documented deviations = none for the policy family covered):

* Gate-and-route family only (static partition; occupancy/priority/FCFS gate;
  solo-first or randomized router).  Per-server-local baselines need the
  per-server engine.
* FCFS-across-classes buffer pulls are realised as proportional-to-queue-length
  sampling (exchangeable-order equivalence; exact in the fluid limit).
* Decodes on the mixed group run at mu_m (Lemma EC.4's convention -- in the
  targeted regime mixed servers essentially always host an active prefill).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.telemetry.probes import PyProbes, resolve_probe_spec

from .policies import PolicySpec
from .types import (Pricing, ServicePrimitives, WorkloadClass, rate_arrays,
                    resolve_primitives)

__all__ = ["CTMCResult", "CTMCSimulator"]


@dataclass
class CTMCResult:
    t_end: float
    revenue: float
    revenue_rate_per_server: float
    completions: np.ndarray
    arrivals: np.ndarray
    abandons_p: np.ndarray
    abandons_d: np.ndarray
    # time-averaged occupancies (per server, fluid scale)
    avg_x: np.ndarray
    avg_ym: np.ndarray
    avg_ys: np.ndarray
    avg_qp: np.ndarray
    avg_qd: np.ndarray
    n_events: int = 0  # transitions actually applied (excl. the final break)
    trajectory: Optional[dict] = field(default=None, repr=False)
    # extract_probes() report for telemetry-enabled runs; summary fields
    # above never depend on it (telemetry-invariance contract)
    telemetry: Optional[dict] = field(default=None, repr=False)


class _View:
    """GateView implementation over the aggregate state."""

    def __init__(self, sim: "CTMCSimulator"):
        self.sim = sim

    def prefill_queue_len(self, i: int) -> int:
        return int(self.sim.Qp[i])

    def prefill_in_service(self, i: int) -> float:
        return float(self.sim.X[i])

    def n_servers(self) -> int:
        return self.sim.n

    def head_of_line_class(self) -> Optional[int]:
        # exchangeable approximation: class proportional to queue length
        tot = self.sim.Qp.sum()
        if tot <= 0:
            return None
        p = self.sim.Qp / tot
        return int(self.sim.rng.choice(self.sim.I, p=p))


class CTMCSimulator:
    """Event-driven exact simulation of the aggregate CTMC.

    ``seed`` accepts an int, a :class:`numpy.random.SeedSequence`, or a
    :class:`numpy.random.Generator`; sweep drivers pass spawned child
    sequences so every grid cell gets a reproducible independent stream.
    One simulator can serve many replications via :meth:`reset` /
    :meth:`run_batch` without rebuilding the policy or rate arrays.
    """

    def __init__(
        self,
        classes: Sequence[WorkloadClass],
        prim: ServicePrimitives,
        pricing: Pricing,
        policy: PolicySpec,
        n: int,
        seed: int = 0,
        record_every: float = 0.0,
        telemetry=None,
    ):
        self.classes = tuple(classes)
        self.prim = prim = resolve_primitives(prim)
        self.pricing = pricing
        self.policy = policy
        self.n = int(n)
        self.arr = rate_arrays(self.classes, prim)
        self.I = len(self.classes)
        self.B = prim.batch_cap
        self.M = policy.mixed_target(self.n)
        self.record_every = record_every
        self.telemetry = resolve_probe_spec(telemetry)

        I = self.I
        self.Qp = np.zeros(I)
        self.X = np.zeros(I)
        self.Qdm = np.zeros(I)  # decode buffer routed to the mixed pool
        self.Qds = np.zeros(I)  # decode buffer routed to the solo pool
        self.Ym = np.zeros(I)
        self.Ys = np.zeros(I)

        self.w = np.array([pricing.bundled_reward(c) for c in self.classes])
        self.w_pre = np.array([pricing.prefill_reward(c) for c in self.classes])
        self.w_dec = np.array([pricing.decode_reward(c) for c in self.classes])

        self.view = _View(self)
        self.rng = np.random.default_rng(seed)
        self.reset()

    # -- replication management ------------------------------------------------
    def snapshot(self) -> dict:
        """Copy of the current Markov state (for warm-starting replications)."""
        return {
            "qp": self.Qp.copy(), "x": self.X.copy(),
            "qdm": self.Qdm.copy(), "qds": self.Qds.copy(),
            "ym": self.Ym.copy(), "ys": self.Ys.copy(),
        }

    def reset(self, rng: Optional[object] = None,
              state: Optional[dict] = None) -> "CTMCSimulator":
        """Re-zero (or warm-start) the state in place for a fresh replication.

        ``rng`` accepts an int seed, a spawned
        :class:`~numpy.random.SeedSequence`, or a ready-made
        :class:`~numpy.random.Generator` stream -- so batch drivers can
        hand each replication its own independent stream; ``None`` keeps
        the current stream. ``state`` is a :meth:`snapshot` dict; omitting
        it restarts empty. All per-class arrays are reused, not
        reallocated.
        """
        if rng is not None:
            self.rng = np.random.default_rng(rng)
        for name, key in (("Qp", "qp"), ("X", "x"), ("Qdm", "qdm"),
                          ("Qds", "qds"), ("Ym", "ym"), ("Ys", "ys")):
            arr = getattr(self, name)
            if state is not None:
                arr[:] = state[key]
            else:
                arr[:] = 0.0
        return self

    def run_batch(self, horizon: float, warmup: float = 0.0, *,
                  rngs: Sequence[object],
                  warm_start: Optional[dict] = None) -> list[CTMCResult]:
        """Run independent replications, one per RNG stream in ``rngs``.

        The simulator object (policy, rate arrays, reward vectors) is reused
        across replications; each entry of ``rngs`` seeds one replication via
        :meth:`reset`.  With ``warm_start`` (a :meth:`snapshot`, e.g. the end
        state of a pilot run) every replication starts from that state, which
        lets callers amortise one warmup across the whole batch.
        """
        out = []
        for r in rngs:
            self.reset(rng=r, state=warm_start)
            out.append(self.run(horizon, warmup=warmup))
        return out

    # -- capacity ------------------------------------------------------------
    @property
    def free_prefill_slots(self) -> int:
        return int(self.M - self.X.sum())

    @property
    def free_mixed_slots(self) -> int:
        cap = 0 if self.policy.prefill_only_mixed else (self.B - 1) * self.M
        return int(cap - self.Ym.sum())

    @property
    def free_solo_slots(self) -> int:
        return int(self.B * (self.n - self.M) - self.Ys.sum())

    # -- control hooks ---------------------------------------------------------
    def _admit_prefills(self) -> None:
        gate = self.policy.gate
        while self.free_prefill_slots > 0:
            waiting = [i for i in range(self.I) if self.Qp[i] >= 1]
            if not waiting:
                return
            i = gate.select(self.view, waiting)
            if i is None:
                return
            self.Qp[i] -= 1
            self.X[i] += 1

    def _route_decode(self, i: int) -> None:
        """A class-i job finished prefill and needs a decode slot."""
        if self.policy.router == "randomized":
            p = float(self.policy.solo_prob[i])
            if self.rng.random() <= p:
                self._enter_pool(i, solo=True)
            else:
                self._enter_pool(i, solo=False)
        else:  # solo_first (default for the aggregate engine)
            if self.free_solo_slots > 0:
                self.Ys[i] += 1
            elif self.free_mixed_slots > 0:
                self.Ym[i] += 1
            else:
                self.Qds[i] += 1  # single logical buffer kept in the solo half

    def _enter_pool(self, i: int, solo: bool) -> None:
        if solo:
            if self.free_solo_slots > 0:
                self.Ys[i] += 1
            else:
                self.Qds[i] += 1
        else:
            if self.free_mixed_slots > 0:
                self.Ym[i] += 1
            else:
                self.Qdm[i] += 1

    def _pull_buffer(self, solo: bool) -> None:
        """A decode slot freed; pull per policy from the matching buffer."""
        if self.policy.router == "randomized":
            q = self.Qds if solo else self.Qdm
            w = (
                self.policy.pool_weights_solo
                if solo
                else self.policy.pool_weights_mixed
            )
            nz = np.nonzero(q >= 1)[0]
            if nz.size == 0:
                return
            if w is None:  # plain randomized router: FCFS-equivalent pull
                p = q[nz] / q[nz].sum()
            else:  # EC.7 general policy: weights restricted to nonempty buffers
                ww = w[nz]
                if ww.sum() <= 0:
                    p = q[nz] / q[nz].sum()
                else:
                    p = ww / ww.sum()
            i = int(self.rng.choice(nz, p=p))
            q[i] -= 1
            (self.Ys if solo else self.Ym)[i] += 1
        else:
            # single logical FCFS buffer (both halves), exchangeable pull
            q = self.Qds + self.Qdm
            tot = q.sum()
            if tot <= 0:
                return
            i = int(self.rng.choice(self.I, p=q / tot))
            if self.Qds[i] >= 1:
                self.Qds[i] -= 1
            else:
                self.Qdm[i] -= 1
            (self.Ys if solo else self.Ym)[i] += 1

    def _record(self, traj: dict, t: float) -> None:
        traj["t"].append(t)
        for key, v in (("x", self.X), ("ym", self.Ym), ("ys", self.Ys),
                       ("qp", self.Qp), ("qd", self.Qdm + self.Qds)):
            traj[key].append(v.copy())

    # -- main loop -------------------------------------------------------------
    def run(self, horizon: float, warmup: float = 0.0) -> CTMCResult:
        arr = self.arr
        I = self.I
        lam_total = self.n * arr["lam"]
        revenue = 0.0
        completions = np.zeros(I)
        arrivals = np.zeros(I)
        ab_p = np.zeros(I)
        ab_d = np.zeros(I)
        # time-averaged state accumulators (measured after warmup)
        acc = {k: np.zeros(I) for k in ("x", "ym", "ys", "qp", "qd")}
        acc_t = 0.0
        traj = (
            {"t": [], "x": [], "ym": [], "ys": [], "qp": [], "qd": []}
            if self.record_every > 0
            else None
        )
        next_rec = 0.0
        n_events = 0
        probes = (PyProbes(self.telemetry,
                           horizon=horizon if horizon > 0 else 1.0,
                           n_servers=self.n, n_classes=I)
                  if self.telemetry is not None else None)

        t = 0.0
        rng = self.rng
        self._admit_prefills()
        while t < horizon:
            rates = np.concatenate(
                [
                    lam_total,  # arrivals
                    arr["mu_p"] * self.X,  # prefill completions
                    arr["mu_m"] * self.Ym,  # mixed decode completions
                    arr["mu_s"] * self.Ys,  # solo decode completions
                    arr["theta"] * self.Qp,  # prefill abandonment
                    arr["theta"] * (self.Qdm + self.Qds),  # decode abandonment
                ]
            )
            total = rates.sum()
            if total <= 0:
                break
            dt = rng.exponential(1.0 / total)
            t_new = min(t + dt, horizon)
            span = t_new - t
            if t_new > warmup:
                eff = t_new - max(t, warmup)
                acc["x"] += eff * self.X
                acc["ym"] += eff * self.Ym
                acc["ys"] += eff * self.Ys
                acc["qp"] += eff * self.Qp
                acc["qd"] += eff * (self.Qdm + self.Qds)
                acc_t += eff
            if traj is not None and t_new >= next_rec:
                # clamp the sample time to the horizon and advance next_rec
                # on the absolute record grid -- anchoring it at
                # t_new + record_every would drift the sampling comb by one
                # inter-event gap per sample (and let the final sample land
                # at an off-grid time when record_every doesn't divide the
                # horizon)
                self._record(traj, min(t_new, horizon))
                next_rec = (
                    np.floor(t_new / self.record_every) + 1.0
                ) * self.record_every
            t = t_new
            if t >= horizon:
                break

            k = int(rng.choice(rates.size, p=rates / total))
            n_events += 1
            cat, i = divmod(k, I)
            if cat == 0:  # arrival
                arrivals[i] += 1
                self.Qp[i] += 1
                self._admit_prefills()
            elif cat == 1:  # prefill completion
                self.X[i] -= 1
                if self.policy.charging == "separate" and t > warmup:
                    revenue += self.w_pre[i]
                self._route_decode(i)
                self._admit_prefills()
            elif cat == 2:  # mixed decode completion
                self.Ym[i] -= 1
                completions[i] += 1
                if t > warmup:
                    revenue += (
                        self.w_dec[i]
                        if self.policy.charging == "separate"
                        else self.w[i]
                    )
                self._pull_buffer(solo=False)
            elif cat == 3:  # solo decode completion
                self.Ys[i] -= 1
                completions[i] += 1
                if t > warmup:
                    revenue += (
                        self.w_dec[i]
                        if self.policy.charging == "separate"
                        else self.w[i]
                    )
                self._pull_buffer(solo=True)
            elif cat == 4:  # prefill abandonment
                self.Qp[i] -= 1
                ab_p[i] += 1
            else:  # decode abandonment
                if self.Qds[i] >= 1 and (
                    self.Qdm[i] < 1 or rng.random() < self.Qds[i] / (self.Qds[i] + self.Qdm[i])
                ):
                    self.Qds[i] -= 1
                else:
                    self.Qdm[i] -= 1
                ab_d[i] += 1
            if probes is not None:
                # post-event state, matching wrap_ctmc_step_probes: queue
                # = Q_p, occupancy = Y_m + Y_s, prefills in flight = X
                if cat >= 4:
                    probes.count(t, drops=1.0)
                probes.sample(
                    t, queue_depth=self.Qp,
                    decode_occupancy=float((self.Ym + self.Ys).sum()),
                    prefill_in_flight=float(self.X.sum()))

        if traj is not None and (not traj["t"] or traj["t"][-1] < t):
            # final sample at the (clamped) end time, so the trajectory
            # always closes at min(t_end, horizon)
            self._record(traj, t)
        meas = max(acc_t, 1e-12)
        return CTMCResult(
            t_end=t,
            revenue=revenue,
            revenue_rate_per_server=revenue / (self.n * meas),
            completions=completions,
            arrivals=arrivals,
            abandons_p=ab_p,
            abandons_d=ab_d,
            avg_x=acc["x"] / meas / self.n,
            avg_ym=acc["ym"] / meas / self.n,
            avg_ys=acc["ys"] / meas / self.n,
            avg_qp=acc["qp"] / meas / self.n,
            avg_qd=acc["qd"] / meas / self.n,
            n_events=n_events,
            trajectory=(
                {k: np.array(v) for k, v in traj.items()} if traj else None
            ),
            telemetry=probes.extract() if probes is not None else None,
        )
