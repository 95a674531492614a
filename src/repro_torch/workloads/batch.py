"""Batched scenario generation (seeds x scenarios) on the device.

The Python :meth:`Scenario.generate` path is exact but serial; sweeps
want *hundreds* of (scenario, seed) traces.  :func:`generate_batch`
evaluates the whole batch with one set of tensor operations over a
leading cell axis (the reference's ``vmap`` over scenarios of a ``vmap``
over seeds); the module keeps the reference's name
(``repro.workloads.batch``).

Representation: every scenario is lowered to a *binned intensity* on a
``T``-point grid over ``[0, H)`` plus per-class length/patience
parameters (padded to the batch's max class count).  Sampling is
Lewis-Shedler thinning against the scenario's rate bound -- ``R``
candidate arrivals at rate ``rate_bound``, each kept with probability
``rate(t)/rate_bound`` -- exact for Poisson and piecewise-constant
intensities whose breakpoints lie on the grid, a binned approximation
otherwise.  MMPP scenarios sample their regime path per cell (a loop of
``T`` small steps, at most one regime switch per bin), so burstiness is
preserved per replication rather than averaged away.

**Random numbers** come from Philox4x32-10 on the device, keyed by each
cell's seed (:func:`repro_torch.compat.prng_key`) and counted per draw,
never from a global generator: the same seeds give the same traces on
the CPU and the card up to the last bits of the transcendental
functions.  The reference's threefry streams cannot be replayed here, so
the port is held to the reference statistically (rate integral, class
shares, length means).  Class labels are drawn by inverse CDF where the
reference takes a Gumbel maximum -- the same law.

Outputs are padded, :class:`repro_torch.data.traces.TraceTensors`-shaped
host arrays ``(S, K, R)``; :func:`batch_cell_tensors` /
:func:`batch_cell_requests` extract one cell for the engines.  The
generator never truncates silently: ``truncated[s, k] = 1`` iff the
candidate budget ``R`` ran out before the horizon (the default budget
makes this a ~4-sigma event).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import prng_key, resolve_device
from repro_torch.data.traces import Request, TraceTensors, validate_requests
from repro_torch.kernels.ctmc_scan.ops import philox4x32, philox_uniforms

from .arrivals import MMPPArrivals
from .scenarios import Scenario

__all__ = [
    "scenario_grid_params",
    "generate_batch",
    "batch_cell_tensors",
    "batch_cell_requests",
    "ScenarioStream",
]

_LEN_FLOOR_P, _LEN_FLOOR_D = 8, 2  # same floors as Scenario.generate
_LEN_CAP = 2 ** 30  # device lengths are cut here before the int cast
# Philox streams (the counter's third word) of generate_batch's draws
_S_REG, _S_GAP, _S_ACC, _S_CLS, _S_P, _S_D = range(6)


def scenario_grid_params(scn: Scenario, horizon_max: float, T: int,
                         I_max: int, K_max: int, compression: float = 1.0,
                         rate_scale: float = 1.0) -> dict:
    """Lower one scenario to the generator's padded parameter arrays."""
    factor = rate_scale / compression
    proc = scn.arrivals if factor == 1.0 else scn.arrivals.scaled(factor)
    dt = horizon_max / T
    mids = (np.arange(T) + 0.5) * dt
    is_mmpp = isinstance(proc, MMPPArrivals)
    if is_mmpp:
        k = proc.n_regimes
        levels = np.zeros(K_max)
        switch = np.ones(K_max)
        levels[:k] = np.asarray(proc.levels, dtype=float)
        switch[:k] = np.asarray(proc.switch, dtype=float)
        rate_grid = np.full(T, proc.mean_rate(horizon_max))  # unused branch
        base = proc.base_rate
    else:
        k = 1
        levels, switch, base = np.zeros(K_max), np.ones(K_max), 0.0
        rate_grid = np.array([proc.rate_at(float(t)) for t in mids])
    shares = np.zeros((T, I_max))
    for b, t in enumerate(mids):
        shares[b, : scn.n_classes] = scn.shares_at(float(t))
    mean_p = np.ones(I_max)
    mean_d = np.ones(I_max)
    cv_p = np.ones(I_max)
    cv_d = np.ones(I_max)
    patience = np.full(I_max, np.inf)
    for i, p in enumerate(scn.profiles):
        mean_p[i], mean_d[i] = p.mean_prompt, p.mean_decode
        cv_p[i], cv_d[i] = p.cv_prompt, p.cv_decode
        patience[i] = p.patience
    return {
        "rate_grid": rate_grid.astype(np.float32),
        "share_log": np.log(np.maximum(shares, 1e-30)).astype(np.float32),
        "is_mmpp": np.float32(1.0 if is_mmpp else 0.0),
        "mmpp_base": np.float32(base),
        "mmpp_levels": levels.astype(np.float32),
        "mmpp_switch": switch.astype(np.float32),
        "mmpp_k": np.int32(k),
        "rate_bound": np.float32(proc.rate_bound()),
        "horizon": np.float32(min(scn.horizon, horizon_max)),
        "mean_p": mean_p.astype(np.float32),
        "mean_d": mean_d.astype(np.float32),
        "cv_p": cv_p.astype(np.float32),
        "cv_d": cv_d.astype(np.float32),
        "patience": patience.astype(np.float32),
    }


def _uniform(keys, stream: int, n: int, dtype):
    """(cells, n) uniforms in [0, 1) of one stream: Philox4x32-10 keyed
    per cell, counter ``(b mod 2**32, b >> 32, stream, 0)`` for the b-th
    block of four words."""
    per = 1 if dtype == torch.float32 else 2
    nb = -(-n * per // 4)
    b = torch.arange(nb, device=keys.device)
    ctr = torch.stack((b & 0xFFFFFFFF, b >> 32, torch.full_like(b, stream),
                       torch.zeros_like(b)), -1)
    w = philox4x32(ctr.expand(keys.shape[0], nb, 4),
                   keys[:, None, :].expand(keys.shape[0], nb, 2))
    return philox_uniforms(w.reshape(keys.shape[0], -1), n, dtype)


def _normal(u1, u2):
    """Box-Muller: standard normals from two uniforms in [0, 1)."""
    return (torch.sqrt(-2.0 * torch.log1p(-u1))
            * torch.cos((2.0 * math.pi) * u2))


def _categorical_cdf(u, probs):
    """Index ~ probs (rows sum to 1) by inverse CDF, clamped in range."""
    cdf = torch.cumsum(probs, -1)
    i = (u[..., None] >= cdf).sum(-1)
    return torch.clamp(i, max=probs.shape[-1] - 1)


def _generate(par: dict, keys, R: int, T: int, dt: float, dtype) -> dict:
    """The generator over a leading cell axis: ``par`` (cells, ...),
    ``keys`` (cells, 2)."""
    cells = keys.shape[0]
    dev = keys.device

    # -- effective intensity grid (MMPP: sample the regime path) --------
    u_reg = _uniform(keys, _S_REG, T, dtype)
    p_sw = 1.0 - torch.exp(-par["mmpp_switch"] * dt)  # (cells, K)
    j = torch.zeros(cells, dtype=torch.int64, device=dev)
    mmpp_grid = torch.empty((cells, T), dtype=dtype, device=dev)
    for b in range(T):
        mmpp_grid[:, b] = par["mmpp_base"] * par["mmpp_levels"].gather(
            1, j[:, None])[:, 0]
        sw = u_reg[:, b] < p_sw.gather(1, j[:, None])[:, 0]
        j = torch.where(sw, torch.where(j + 1 >= par["mmpp_k"], 0, j + 1), j)
    rate_grid = torch.where(par["is_mmpp"][:, None] > 0, mmpp_grid,
                            par["rate_grid"])

    # -- candidate arrivals at the bound, thinned to rate(t) ------------
    bound = torch.clamp_min(par["rate_bound"], 1e-9)[:, None]
    gaps = -torch.log1p(-_uniform(keys, _S_GAP, R, dtype)) / bound
    times = torch.cumsum(gaps, 1)
    bins = torch.clamp((times / dt).to(torch.int64), 0, T - 1)
    lam_t = rate_grid.gather(1, bins)
    u = _uniform(keys, _S_ACC, R, dtype)
    horizon = par["horizon"][:, None]
    accept = (times < horizon) & (u * bound < lam_t)
    truncated = times[:, R - 1] < par["horizon"]

    # -- class labels + lognormal lengths + patience --------------------
    I = par["share_log"].shape[2]
    logits = par["share_log"].gather(1, bins[:, :, None].expand(cells, R, I))
    cls = _categorical_cdf(_uniform(keys, _S_CLS, R, dtype),
                           torch.softmax(logits, -1))

    def lengths(stream, mean, cv, floor):
        u12 = _uniform(keys, stream, 2 * R, dtype)
        z = _normal(u12[:, :R], u12[:, R:])
        cvc, mc = cv.gather(1, cls), mean.gather(1, cls)
        sigma2 = torch.log1p(cvc * cvc)
        mu = torch.log(mc) - sigma2 / 2
        val = torch.exp(mu + torch.sqrt(sigma2) * z)
        return torch.clamp_min(torch.clamp_max(val, _LEN_CAP).to(
            torch.int64), floor)

    P = lengths(_S_P, par["mean_p"], par["cv_p"], _LEN_FLOOR_P)
    D = lengths(_S_D, par["mean_d"], par["cv_d"], _LEN_FLOOR_D)
    pat = par["patience"].gather(1, cls)

    # -- compact accepted rows to the front (stable by time) ------------
    t_keyed = torch.where(accept, times, math.inf)
    t_s, order = torch.sort(t_keyed, dim=1, stable=True)
    valid = torch.isfinite(t_s)
    return {
        "t": t_s,
        "cls": torch.where(valid, cls.gather(1, order), 0).to(torch.int32),
        "P": torch.where(valid, P.gather(1, order), 1).to(torch.int32),
        "D": torch.where(valid, D.gather(1, order), 1).to(torch.int32),
        "patience": torch.where(valid, pat.gather(1, order), math.inf),
        "valid": valid,
        "n_real": valid.sum(1).to(torch.int32),
        "truncated": truncated.to(torch.int32),
    }


@torch.inference_mode()
def generate_batch(scenarios: Sequence[Scenario], seeds: Sequence[int],
                   horizon: Optional[float] = None, T: int = 512,
                   R: Optional[int] = None, compression: float = 1.0,
                   rate_scale: float = 1.0, *, dtype=torch.float32,
                   device=None) -> dict:
    """Generate ``len(scenarios) x len(seeds)`` traces as ONE batch.

    Returns host ``numpy`` arrays shaped ``(S, K, R)`` (``t``/``cls``/
    ``P``/``D``/``patience``/``valid``) plus ``(S, K)`` ``n_real`` and
    ``truncated`` counters and the shared ``R``/``horizon`` under
    ``"meta"``.  Shorter scenarios simply stop accepting at their own
    horizon.  ``device``: the card unless ``"cpu"`` is passed.
    """
    if not scenarios or not len(seeds):
        raise ValueError("need at least one scenario and one seed")
    dev = resolve_device(device)
    H = float(horizon if horizon is not None
              else max(s.horizon for s in scenarios))
    I_max = max(s.n_classes for s in scenarios)
    K_max = max((s.arrivals.n_regimes
                 for s in scenarios if isinstance(s.arrivals, MMPPArrivals)),
                default=1)
    params = [scenario_grid_params(s, H, T, I_max, K_max,
                                   compression=compression,
                                   rate_scale=rate_scale)
              for s in scenarios]
    if R is None:
        # candidate budget: bound * horizon + 4 sigma + slack
        need = max(float(p["rate_bound"]) * H for p in params)
        R = int(need + 4.0 * np.sqrt(max(need, 1.0)) + 64)
    S, K = len(scenarios), len(seeds)

    def cellwise(k):  # (S, ...) -> (S * K, ...), scenario-major
        v = torch.as_tensor(np.stack([np.asarray(p[k]) for p in params]),
                            device=dev)
        v = v.to(torch.int64) if k == "mmpp_k" else v.to(dtype)
        return v.repeat_interleave(K, 0)

    par = {k: cellwise(k) for k in params[0]}
    keys = torch.stack([prng_key(int(s)) for s in seeds]).to(dev).repeat(S, 1)
    out = _generate(par, keys, int(R), int(T), H / T, dtype)
    out = {k: v.reshape((S, K) + tuple(v.shape[1:])).cpu().numpy()
           for k, v in out.items()}
    out["meta"] = {
        "R": int(R), "T": int(T), "horizon": H,
        "scenarios": [s.name for s in scenarios],
        "seeds": [int(s) for s in seeds],
    }
    return out


class ScenarioStream:
    """Stream one scenario's trace as fixed-shape chunks.

    :func:`generate_batch` materialises a whole ``(S, K, R)`` candidate
    table up front, so its memory ceiling is the trace length.  This
    stream draws the *same law* -- Lewis-Shedler thinning against the
    scenario's rate bound, per-class lognormal lengths, an MMPP regime
    path on the ``T``-point grid -- but hands out padded
    :class:`TraceTensors` chunks of ``chunk_size`` *candidates* at a
    time, so a streamed replay can consume millions of requests while
    holding one chunk.

    Chunk-size invariance: every candidate draws its randomness on the
    device from Philox counted by its global candidate index, and the
    arrival clock accumulates strictly left-to-right in float64 on the
    host, so the concatenation of the emitted chunks is bitwise
    independent of ``chunk_size``.  The MMPP regime path is the
    reference's, drawn on the host from ``numpy``'s generator.

    ``next_chunk()`` returns ``None`` once the candidate clock passes
    the horizon; the final real chunk may be partially filled.
    """

    def __init__(self, scenario: Scenario, seed: int,
                 chunk_size: int = 4096, horizon: Optional[float] = None,
                 T: int = 512, compression: float = 1.0,
                 rate_scale: float = 1.0, *, dtype=torch.float32,
                 device=None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.scenario = scenario
        self.chunk_size = int(chunk_size)
        self.horizon = float(horizon if horizon is not None
                             else scenario.horizon)
        self.device = resolve_device(device)
        self.dtype = dtype
        I = scenario.n_classes
        K = (scenario.arrivals.n_regimes
             if isinstance(scenario.arrivals, MMPPArrivals) else 1)
        par = scenario_grid_params(scenario, self.horizon, T, I, K,
                                   compression=compression,
                                   rate_scale=rate_scale)
        self._dt = self.horizon / T
        self._T = int(T)
        self._bound = max(float(par["rate_bound"]), 1e-9)
        # one regime path per stream (emitted rate first, then the switch
        # draw), sampled once so every chunk thins against the same grid
        if float(par["is_mmpp"]) > 0:
            rng = np.random.default_rng(seed)
            grid = np.empty(T)
            j = 0
            for b in range(T):
                grid[b] = float(par["mmpp_base"] * par["mmpp_levels"][j])
                p_switch = 1.0 - np.exp(-float(par["mmpp_switch"][j])
                                        * self._dt)
                if rng.uniform() < p_switch:
                    j = 0 if j + 1 >= int(par["mmpp_k"]) else j + 1
            self._rate_grid = grid
        else:
            self._rate_grid = par["rate_grid"].astype(np.float64)
        shares = np.exp(par["share_log"].astype(np.float64))  # (T, I)
        shares /= np.maximum(shares.sum(axis=1, keepdims=True), 1e-30)
        self._cdf = np.cumsum(shares, axis=1)
        self._mean_p = par["mean_p"].astype(np.float64)
        self._mean_d = par["mean_d"].astype(np.float64)
        self._cv_p = par["cv_p"].astype(np.float64)
        self._cv_d = par["cv_d"].astype(np.float64)
        self._patience = par["patience"].astype(np.float64)
        self._key = prng_key(int(seed))[None].to(self.device)
        self._i0 = 0
        self._t = 0.0
        self._done = False
        self.n_emitted = 0

    @property
    def exhausted(self) -> bool:
        return self._done

    @torch.inference_mode()
    def _draw(self, i0: int, C: int):
        """Candidates ``i0 .. i0 + C - 1``: exponential gap, acceptance
        and class uniforms, prompt and decode normals -- (5, C) float64
        on the host.  Candidate i takes the words of Philox counter
        ``(i mod 2**32, i >> 32, j, 0)``, j = 0, 1 (7 of its 8 words in
        float32, 14 of 16 in float64)."""
        per = 1 if self.dtype == torch.float32 else 2
        J = -(-7 * per // 4)
        i = torch.arange(i0, i0 + C, device=self.device)[:, None]
        j = torch.arange(J, device=self.device)[None, :]
        ctr = torch.stack(torch.broadcast_tensors(
            i & 0xFFFFFFFF, i >> 32, j, torch.zeros_like(j)), -1)
        w = philox4x32(ctr, self._key.expand(C, J, 2)).reshape(C, 4 * J)
        u = philox_uniforms(w, 7, self.dtype)
        g = -torch.log1p(-u[:, 0])
        zp, zd = _normal(u[:, 3], u[:, 4]), _normal(u[:, 5], u[:, 6])
        return torch.stack([g, u[:, 1], u[:, 2], zp, zd]).cpu().numpy() \
            .astype(np.float64)

    def next_chunk(self) -> Optional[TraceTensors]:
        if self._done:
            return None
        C = self.chunk_size
        g, ua, uc, zp, zd = self._draw(self._i0, C)
        self._i0 += C
        # strict left-to-right accumulation including the carried clock:
        # the association (and hence every bit) matches any chunking
        times = np.add.accumulate(
            np.concatenate(([self._t], g / self._bound)))[1:]
        self._t = float(times[-1])
        bins = np.clip((times / self._dt).astype(np.int64), 0, self._T - 1)
        accept = ((times < self.horizon)
                  & (ua * self._bound < self._rate_grid[bins]))
        cls = np.minimum((uc[:, None] >= self._cdf[bins]).sum(axis=1),
                         self._cdf.shape[1] - 1)

        def lengths(z, mean, cv, floor):
            sigma2 = np.log1p(cv[cls] * cv[cls])
            mu = np.log(mean[cls]) - sigma2 / 2
            val = np.exp(mu + np.sqrt(sigma2) * z)
            return np.maximum(floor, val.astype(np.int64)).astype(np.int32)

        P = lengths(zp, self._mean_p, self._cv_p, _LEN_FLOOR_P)
        D = lengths(zd, self._mean_d, self._cv_d, _LEN_FLOOR_D)
        n = int(accept.sum())
        t = np.full(C, np.inf)
        cl = np.zeros(C, np.int32)
        Pp = np.ones(C, np.int32)
        Dd = np.ones(C, np.int32)
        pat = np.full(C, np.inf)
        valid = np.zeros(C, bool)
        t[:n] = times[accept]
        cl[:n] = cls[accept]
        Pp[:n] = P[accept]
        Dd[:n] = D[accept]
        pat[:n] = self._patience[cls[accept]]
        valid[:n] = True
        self.n_emitted += n
        if self._t >= self.horizon:
            self._done = True
        return TraceTensors(rid=np.arange(C, dtype=np.int32), t=t,
                            cls=cl, P=Pp, D=Dd, patience=pat,
                            valid=valid, n_real=n)


def batch_cell_tensors(batch: dict, s: int, k: int) -> TraceTensors:
    """One (scenario, seed) cell as engine-ready :class:`TraceTensors`."""
    valid = batch["valid"][s, k]
    R = valid.shape[0]
    t = batch["t"][s, k].astype(np.float64)
    t[~valid] = np.inf
    return TraceTensors(
        rid=np.arange(R, dtype=np.int32),
        t=t,
        cls=batch["cls"][s, k].astype(np.int32),
        P=batch["P"][s, k].astype(np.int32),
        D=batch["D"][s, k].astype(np.int32),
        patience=batch["patience"][s, k].astype(np.float64),
        valid=valid.astype(bool),
        n_real=int(batch["n_real"][s, k]),
        n_dropped=0,
    )


def batch_cell_requests(batch: dict, s: int, k: int) -> list:
    """One (scenario, seed) cell as a validated ``list[Request]``."""
    tt = batch_cell_tensors(batch, s, k)
    reqs = [Request(int(tt.rid[i]), float(tt.t[i]), int(tt.cls[i]),
                    int(tt.P[i]), int(tt.D[i]), float(tt.patience[i]))
            for i in range(tt.R) if tt.valid[i]]
    name = batch["meta"]["scenarios"][s]
    return list(validate_requests(reqs, source=f"generate_batch:{name}"))
