"""Batched iteration-level trace-replay engine.

Same system as :class:`repro_torch.serving.engine_sim.ClusterEngine` --
the paper's calibrated per-server scheduling simulator (Section 6.2):
each logical server advances in iterations, a mixed iteration (one
prefill chunk of up to C tokens + co-resident decode streams) takes
``tau_mix = alpha + beta * chunk`` seconds, a decode-only iteration
``tau_solo(K) = a_s + b_s * K`` (K = resident KV tokens) -- re-expressed
so the event loop is a loop of structurally identical, branch-free steps
over a batch of replications.  The module keeps the reference's name
(``repro.serving.engine_jax``) so that a reader finds its counterpart;
it imports no JAX.

**The step** is the reference's ``_build_step``, op for op, with an
explicit leading replication axis where the reference has ``jax.vmap``:
every carry and parameter tensor has shape ``(nr, ...)``.  One event per
step (or ``k_events`` per step, with the reference's deferred and merged
``(R,)``-scatter flushes, bitwise identical to k single events), the
closed-form fast-forward window (``fastforward``), the three gates and
four routers, static / none partitions with Sarathi and unchunked
budgets, deadline expiry, the affine and table iteration-time models,
per-server surfaces for a heterogeneous fleet, and the telemetry probes
(:func:`repro_torch.telemetry.probes.wrap_engine_step_probes`).  The
module docstring of the reference carries the derivations (pointer-pair
queues, ranked dispatch, one admission per event, the budget bound);
they hold here unchanged.

**The loop.**  The reference's ``lax.while_loop`` (``loop="while"``) and
``lax.scan`` (``loop="scan"``) become a host loop over *blocks* of
:data:`BLOCK_STEPS` steps.  Each step is guarded
by the reference's loop condition per replication -- ``alive & (i <
n_blocks)`` for ``while``, ``i < n_blocks`` for ``scan``, the chunk
frontier, the horizon and the budget for a streamed segment -- exactly
the ``select`` a vmapped ``while_loop`` applies, so steps past the
condition change nothing.  The host reads one flag per block (is any
replication's condition still true), never one per step.  On the card a
block is captured once as a CUDA graph, cached per statics and shapes
(as ``jax.jit`` caches per static), and replayed; the graph's input
buffers are refilled from each call's parameters and carry.  A capture
that fails raises: there is no eager fallback on the card.  On the CPU
the same block runs eagerly -- the tests' route.

**Arithmetic.**  Every expression keeps the reference's operation order
(no fused multiply-add, no ``torch.compile``), so float32 times agree
with the reference's to rounding and discrete outcomes agree exactly on
the deterministic routers.  Scatters: ``.at[].max/.min`` are
``scatter_reduce`` with ``amax``/``amin`` (deterministic);
``.at[].set`` is used only with one index per replication; float
``.at[].add`` adds only integer-valued counts (0/1 token and pending
counts), exact in float32 below 2**24 whatever order the card's atomics
take.  ``argmin``/``argmax`` return the first index, as the reference's
arrival-first and first-free-slot ties need.  Index-valued state (rids,
cursors, lifecycle codes) is int64 where the reference has int32.

**Random numbers.**  The randomized router draws its ``2 B + 3``
uniforms per event from Philox4x32-10 (:mod:`repro_torch.kernels.
ctmc_scan.ops`) keyed by the replication's key and counted by the
global event index -- the reference's ``fold_in(key, idx)`` -- so the
CPU and the card draw the same bits, and a whole block's uniforms are
drawn in one call at its start.  The streams differ from JAX's
threefry, so randomized policies match the reference statistically.

Not supported (as in the reference): server failures, stragglers, the
online controller and ``record_queues_every``.  ``placement="shard_map"``
comes with the sweep layer (ROADMAP A8) and raises until then.  Streamed
replay over a compacted working set lives in
:mod:`repro_torch.serving.engine_stream`.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import prng_key, resolve_device
from repro_torch.core.ctmc_jax import _categorical
from repro_torch.core.policies import (FCFSGate, OccupancyGate, PolicySpec,
                                       PriorityRatioGate)
from repro_torch.core.types import WorkloadClass
from repro_torch.data.traces import TraceTensors, tensorize_trace
from repro_torch.kernels.ctmc_scan.ops import philox4x32, philox_uniforms
from repro_torch.telemetry.probes import (extract_probes, hist_edges,
                                          probe_carry, resolve_probe_spec,
                                          wrap_engine_step_probes)

from .engine_sim import EngineConfig

__all__ = ["BLOCK_STEPS", "ClusterEngineJAX", "iteration_budget", "run",
           "run_engine", "run_engine_batch", "run_engine_multi"]

# request lifecycle (codes carried through the loop)
_NOT_ARRIVED, _QUEUED, _PREFILL, _BUF, _DECODE, _DONE, _ABANDONED = range(7)

_EPS_TARGET = 1e-12  # OccupancyGate's "class is never admitted" threshold
_INT32_MAX = 2 ** 31 - 1

#: steps per block: one CUDA-graph replay on the card, one host read of
#: the loop flag per block on either device
BLOCK_STEPS = 32


def _gate_kind(policy: PolicySpec) -> str:
    gate = policy.gate
    if isinstance(gate, OccupancyGate):
        return "occupancy"
    if isinstance(gate, PriorityRatioGate):
        return "priority"
    if isinstance(gate, FCFSGate):
        return "fcfs"
    raise ValueError(
        f"engine_jax does not support gate {type(gate).__name__}; "
        "use the Python ClusterEngine")


def iteration_budget(tt: TraceTensors, cfg: EngineConfig, h_eff: float,
                     *, arrived: Optional[np.ndarray] = None) -> int:
    """Hard upper bound on events (arrivals + iteration completions).

    ``min(pathwise, clock)`` -- both bounds are deterministic given the
    trace, so no Poisson slack is needed (the reference's module
    docstring and ``docs/SIMULATORS.md`` carry the derivation).
    """
    prim = cfg.prim
    if arrived is None:
        arrived = tt.valid & (tt.t <= h_eff)
    A = int(arrived.sum())
    P = tt.P[arrived].astype(np.float64)
    D = tt.D[arrived].astype(np.float64)
    if cfg.vllm_unchunked:
        chunks = np.ones_like(P)
    elif cfg.sarathi_budget:
        c_min = max(1, prim.chunk - (prim.batch_cap - 1))
        chunks = np.ceil(P / c_min)
    else:
        chunks = np.ceil(P / prim.chunk)
    pathwise = float(chunks.sum() + D.sum())
    m = cfg.iter_model
    if m is not None:
        # lower-bound the iteration time under the plugged model: affine
        # surfaces are minimal at (C=1, K=0); a table model's true min is
        # over its knot values (constant extrapolation beyond them)
        tau_min = min(m.tau_mix(1.0), m.tau_solo(0.0))
        if hasattr(m, "knots"):
            kn = m.knots()
            tau_min = min(min(kn["mix_y"]), min(kn["solo_y"]))
    elif cfg.fleet is not None:
        # fastest class lower-bounds every server's iteration time (the
        # KV-transfer charge only ever adds time, so it never loosens
        # this bound)
        fp = cfg.fleet.server_params(prim)
        tau_min = float(min((fp["alpha"] + fp["beta"]).min(),
                            fp["tau_solo"].min()))
    else:
        tau_min = min(prim.alpha + prim.beta, prim.tau_solo)
    clock = cfg.n_servers * (h_eff / tau_min + 1.0)
    return A + int(np.ceil(min(pathwise, clock))) + 16


_FFWD_JMAX = 64  # boundaries scanned per fast-forward window (per step)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` row by row: ``x`` (nr, m), knots (nr, K);
    the reference's expression, constant beyond the knots."""
    K = xp.shape[1]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, K - 1)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    df = f1 - f0
    dx = x1 - x0
    delta = x - x0
    eps = float(np.spacing(np.finfo(
        np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def _uniforms(keys, ctr0, n_ctr: int, n: int, dtype):
    """The ``n`` uniforms in [0, 1) of events ``ctr0 .. ctr0 + n_ctr - 1``
    of each replication: (nr, n_ctr, n).

    Event e's words come from Philox4x32-10 calls with counters
    ``(e mod 2**32, e >> 32, j, 0)``, j = 0, 1, ...; float32 takes 24
    bits of one word, float64 53 bits of two (27 + 26)."""
    per = 1 if dtype == torch.float32 else 2
    J = -(-n * per // 4)
    nr = keys.shape[0]
    e = ctr0[:, None] + torch.arange(n_ctr, device=keys.device)  # (nr, n_ctr)
    j = torch.arange(J, device=keys.device)
    e3 = e[:, :, None].expand(nr, n_ctr, J)
    ctr = torch.stack((e3 & 0xFFFFFFFF, e3 >> 32,
                       j.expand(nr, n_ctr, J), torch.zeros_like(e3)), -1)
    w = philox4x32(ctr, keys[:, None, None, :].expand(nr, n_ctr, J, 2))
    return philox_uniforms(w.reshape(nr, n_ctr, 4 * J), n, dtype)


def _build_step(params: dict, *, n: int, B: int, gate_kind: str,
                router_kind: str, charging: str, partition: str,
                sarathi: bool, unchunked: bool, prefill_only: bool,
                has_pw: bool, expiry: bool, model_kind: str = "affine",
                k_events: int = 1, fastforward: bool = False,
                telemetry=None):
    """The batched step ``step(carry, run, U) -> carry``.

    ``params`` hold the replication axis first; ``run`` (nr,) bool is the
    loop condition per replication (a step with ``run`` false changes
    nothing); ``U`` (nr, k_events, 2 B + 3) holds the randomized router's
    uniforms for the step's events (None for the other routers)."""
    t_arr, cls = params["t_arr"], params["cls"]
    dtype, dev = t_arr.dtype, t_arr.device
    nr, R = t_arr.shape
    I = params["x_star"].shape[1]
    nB = n * B
    W = B + 1  # placement bound per event: freed slots + the routed job
    tlm = telemetry
    sid = torch.arange(n, device=dev)[None, :]
    iota_I = torch.arange(I, device=dev)[None, :]
    iota_W = torch.arange(W, device=dev)[None, :]
    ar = torch.arange(nr, device=dev)
    inf = math.inf
    P, D, patience = params["P"], params["D"], params["patience"]
    A, h_eff = params["A"], params["h_eff"]
    Bp, C = params["B"][:, None], params["C"][:, None]
    Mi = params["Mi"][:, None]
    perm_srv = params["perm_srv"]
    c_p, c_d = params["c_p"], params["c_d"]
    x_star, qp_star, n_f = params["x_star"], params["qp_star"], params["n_f"]

    def col(v):  # a surface scalar (nr,) or per-server (nr, n) array
        return v[:, None] if v.dim() == 1 else v

    alpha, beta = col(params["alpha"]), col(params["beta"])
    tau_solo, b_s = col(params["tau_solo"]), col(params["b_s"])
    kv_xfer = col(params["kv_xfer"])
    frontier = params.get("frontier")
    if model_kind == "table":  # searchsorted wants contiguous knots
        knots = {k: params[k].contiguous()
                 for k in ("mix_x", "mix_y", "solo_x", "solo_y")}
    # the ranked-assignment routers never read per-request lifecycle
    # state inside the step, so every ``st`` write is deferred into ONE
    # combined scatter-max per step
    fast_st = router_kind in ("solo_first", "local_fcfs")
    need_tbuf = (expiry or router_kind == "immediate"
                 or (router_kind == "randomized" and has_pw))
    multi = k_events > 1
    if fastforward and not (fast_st and model_kind == "affine"):
        raise ValueError("fastforward needs a deterministic global-buffer "
                         "router (solo_first/local_fcfs) and the affine "
                         "iteration-time model")
    dense_tout = fast_st and (multi or fastforward)

    def f(b):
        return b.to(dtype)

    def rc(idx):
        return torch.clamp(idx, 0, R - 1)

    def g1(x, i):  # x (nr, M)[i] for i (nr,)
        return x.gather(1, i[:, None])[:, 0]

    def smax(x, i, v):  # x.at[i].max(v), row by row
        return x.scatter_reduce(1, i.reshape(nr, -1), v.reshape(nr, -1),
                                "amax")

    def smin(x, i, v):
        return x.scatter_reduce(1, i.reshape(nr, -1), v.reshape(nr, -1),
                                "amin")

    def sset(x, i, v):  # x.at[i].set(v) with one index per replication
        return x.scatter(1, i[:, None], v[:, None])

    def on_slots(x, fn, i, v):  # a scatter into the (n, B) slot arrays
        return fn(x.reshape(nr, nB), i, v).reshape(nr, n, B)

    def used_of(slot_rid):
        return f(slot_rid >= 0).sum(2)  # (nr, n)

    def cap_of(pf_rid):
        """Per-server decode-slot capacity given current prefill state."""
        has_pf = f(pf_rid >= 0)
        if partition == "none":
            return Bp - has_pf
        mixed = sid < Mi
        cap_mixed = (torch.zeros_like(has_pf) if prefill_only
                     else Bp - has_pf)
        return torch.where(mixed, cap_mixed, Bp)

    def place_into(c, srv_i, j, ok):
        """Scatter job ``j`` into the first empty slot of server
        ``srv_i`` (masked by ``ok``) and flip its lifecycle state.
        Used by the sequential (immediate / randomized) dispatchers."""
        row = c["slot_rid"][ar, srv_i]
        slot = (row < 0).to(torch.uint8).argmax(1)
        c["slot_rid"] = on_slots(c["slot_rid"], smax, srv_i * B + slot,
                                 torch.where(ok, j, -1))
        c["st"] = smax(c["st"], rc(j), torch.where(ok, _DECODE, -1))
        if "srv" in c:
            c["srv"] = sset(c["srv"], rc(j),
                            torch.where(ok, srv_i, g1(c["srv"], rc(j))))
        return c

    def wake(c, now, active, force_solo, used):
        """Start an iteration on every non-busy server with work
        (snapshot semantics: resident decodes join, chunk is fixed).
        ``force_solo`` marks servers the Python engine would have woken
        *during* dispatch, before admission could hand them a prefill;
        ``used`` is the occupied slot count of each server."""
        has_pf = c["pf_rid"] >= 0
        do = active[:, None] & ~c["busy"] & (has_pf | (used > 0))
        pl = c["pf_left"]  # per-server: one active prefill per server
        if unchunked:
            chn = pl
        elif sarathi:
            chn = torch.minimum(torch.clamp_min(C - used, 0.0), pl)
        else:
            chn = torch.minimum(pl, C)
        chn = torch.where(has_pf & ~force_solo, chn, 0.0)
        occupied = c["slot_rid"] >= 0
        src = rc(c["slot_rid"]).reshape(nr, nB)
        pfr = rc(c["pf_rid"])
        tout_res = (c["slot_tout"] if dense_tout
                    else c["tout"].gather(1, src).reshape(nr, n, B))
        kv = (torch.where(occupied,
                          P.gather(1, src).reshape(nr, n, B) + tout_res,
                          0.0).sum(2)
              + torch.where(has_pf, P.gather(1, pfr) - pl, 0.0))
        if model_kind == "table":
            tau = torch.where(
                has_pf & (chn > 0),
                _interp(chn, knots["mix_x"], knots["mix_y"]),
                _interp(kv, knots["solo_x"], knots["solo_y"]))
        else:
            tau = torch.where(has_pf & (chn > 0), alpha + beta * chn,
                              tau_solo + b_s * kv)
        # KV-transfer charge of the chunk that FINISHES a prefill (0.0
        # without a fleet: an exact + 0.0)
        fin = has_pf & (chn > 0.0) & (chn >= pl)
        tau = tau + f(fin) * (kv_xfer * P.gather(1, pfr))
        c["chunk"] = torch.where(do, chn, c["chunk"])
        c["t_next"] = torch.where(do, now[:, None] + tau, c["t_next"])
        c["busy"] = c["busy"] | do
        c["slot_live"] = c["slot_live"] | (do[:, :, None] & occupied)
        return c

    if fastforward:
        # stacked per-request constants: one gather where two would do
        DP2 = torch.stack([D, P], 1)  # (nr, 2, R)
        AC2 = torch.stack([t_arr, f(cls)], 1)
        jj = torch.arange(_FFWD_JMAX, dtype=dtype, device=dev)[None, None, :]
        jw = torch.arange(_FFWD_JMAX, device=dev)[None, :]

    def ffwd(c, run):
        """Retire a batch of non-interacting events in closed form (the
        reference's ``ffwd``; see its docstring)."""
        t0 = c["t_next"]  # (nr, n) first-boundary times (exact)
        occ = c["slot_rid"] >= 0
        L = f(occ).sum(2)
        rr2 = rc(c["slot_rid"]).reshape(nr, 1, nB)
        dp = DP2.gather(2, rr2.expand(nr, 2, nB)).reshape(nr, 2, n, B)
        # tokens to the earliest resident completion (>= 1 by
        # invariant); a not-yet-woken resident poisons the min to -inf
        d = torch.where(occ, torch.where(c["slot_live"],
                                         dp[:, 0] - c["slot_tout"], -inf),
                        inf).amin(2)
        has_pf = c["pf_rid"] >= 0
        pl, chn = c["pf_left"], c["chunk"]
        kv0 = torch.where(occ, dp[:, 1] + c["slot_tout"], 0.0).sum(2)
        tau_pf = alpha + beta * chn

        def T(j):  # time of boundary index j (j = 0 -> t_next)
            dec = j * tau_solo + b_s * (j * kv0 + L * j * (j - 1.0) / 2.0)
            return t0 + torch.where(has_pf, j * tau_pf, dec)

        jC = d - 1.0
        jF = torch.ceil(pl / torch.clamp_min(chn, 1.0)) - 1.0
        jint = torch.where(has_pf, torch.minimum(jC, jF), jC)
        okb = (c["busy"] & (d > 0.0)
               & torch.where(has_pf, chn > 0, True))
        # a waiting head plus an admission-capable server means the very
        # next event performs an admission: the window must be empty
        qlen0 = f(c["qarr"] - c["qhead"])
        no_pf0 = c["pf_rid"] < 0
        if partition == "none":
            canp0 = no_pf0 & (L < Bp)
            if sarathi:
                canp0 = canp0 & (L < Bp - 1.0)
        else:
            canp0 = (sid < Mi) & no_pf0 & (L <= Bp - 1.0)
        if gate_kind == "occupancy":
            waiting = (qlen0 >= 1) & (x_star > _EPS_TARGET)
        else:
            waiting = qlen0 >= 1
        blocked = canp0.any(1) & waiting.any(1)
        if expiry:  # lazy head-expiry also fires once per event
            blocked = blocked | (qlen0 >= 1).any(1)
        okb = okb & ~blocked[:, None] & run[:, None]
        jint = torch.where(okb, torch.clamp_min(jint, 0.0), 0.0)
        t_int = torch.where(okb, T(jint), t0)  # non-batchable: t_next
        t_imin = t_int.amin(1)
        a0 = c["aptr"]
        aw = a0[:, None] + jw
        acw = AC2.gather(2, rc(aw)[:, None, :].expand(nr, 2, _FFWD_JMAX))
        taw = torch.where(f(aw) < A[:, None], acw[:, 0], inf)
        ta0 = taw[:, 0]
        # with no admission-capable server an arrival merely joins its
        # class queue, so arrivals and boundaries commute
        no_adm = (torch.zeros_like(run) if expiry else ~canp0.any(1))
        t_cap = torch.where(no_adm, t_imin, torch.minimum(ta0, t_imin))
        if frontier is not None:
            # streamed replay: never batch past the next chunk's splice
            t_cap = torch.minimum(t_cap, frontier)
        t0B, kvB, LB = t0[:, :, None], kv0[:, :, None], L[:, :, None]
        Tj = (t0B
              + torch.where(has_pf[:, :, None], jj * tau_pf[:, :, None],
                            jj * tau_solo[:, :, None]
                            + b_s[:, :, None] * (jj * kvB + LB * jj
                                                 * (jj - 1.0) / 2.0)))
        okj = ((Tj < t_cap[:, None, None]) & (Tj <= h_eff[:, None, None])
               & (jj < jint[:, :, None]))
        j_s = torch.where(okb, f(okj).sum(2), 0.0)
        adv = j_s > 0
        # post-window state, computed exactly like the per-boundary wake
        pl2 = pl - j_s * chn
        if unchunked:
            chn2 = pl2
        elif sarathi:
            chn2 = torch.minimum(torch.clamp_min(C - L, 0.0), pl2)
        else:
            chn2 = torch.minimum(pl2, C)
        tau2 = torch.where(has_pf, alpha + beta * chn2,
                           tau_solo + b_s * (kv0 + j_s * L))
        fin2 = has_pf & (chn2 > 0.0) & (chn2 >= pl2)
        tau2 = tau2 + f(fin2) * (kv_xfer * P.gather(1, rc(c["pf_rid"])))
        t_last_b = T(j_s - 1.0)  # last batched boundary time
        c["t_next"] = torch.where(adv, t_last_b + tau2, c["t_next"])
        c["pf_left"] = torch.where(adv & has_pf, pl2, c["pf_left"])
        c["chunk"] = torch.where(adv & has_pf, chn2, c["chunk"])
        emit = occ & adv[:, :, None]
        c["slot_tout"] = c["slot_tout"] + f(emit) * j_s[:, :, None]
        c["t_first"] = smin(c["t_first"], rr2,
                            torch.where(emit, t0[:, :, None], inf))
        nb = j_s.sum(1)
        c["n_iters"] = c["n_iters"] + nb
        c["n_events"] = c["n_events"] + nb
        c["t"] = torch.maximum(c["t"], torch.where(adv, t_last_b,
                                                   -inf).amax(1))
        if not expiry:
            # queue-only arrival batch strictly before the earliest
            # pending interaction (a prefix of the lookahead window)
            okm = (no_adm & run)[:, None] & (taw < t_imin[:, None])
            m_arr = okm.sum(1)
            c["aptr"] = a0 + m_arr
            c["st"] = smax(c["st"], rc(aw), torch.where(okm, _QUEUED, -1))
            c["qarr"] = c["qarr"].scatter_add(
                1, acw[:, 1].to(torch.int64), torch.where(okm, 1, 0))
            c["n_events"] = c["n_events"] + f(m_arr)
            c["t"] = torch.maximum(c["t"], torch.where(okm, taw,
                                                       -inf).amax(1))
        return c

    def event(c, run, u, dfr):
        # ``dfr`` holds the cross-event deferred (R,)-scatter buffers of
        # the enclosing k-block (None in the single-event body)
        st_idx, st_val = [], []  # deferred combined scatter (fast_st)

        def st_max(c, idx_, val_):
            if fast_st:
                (dfr["st_i"] if multi else st_idx).append(
                    idx_.reshape(nr, -1))
                (dfr["st_v"] if multi else st_val).append(
                    val_.reshape(nr, -1))
            else:
                c["st"] = smax(c["st"], idx_, val_)
            return c

        def mark_first(c, idx_, val_):
            if multi:  # write-only in-step: the scatter-min defers k-wide
                dfr["tf_i"].append(idx_)
                dfr["tf_v"].append(val_)
            else:
                c["t_first"] = smin(c["t_first"], idx_, val_)
            return c

        def mark_last(c, idx_, val_):
            if multi:
                dfr["tl_i"].append(idx_)
                dfr["tl_v"].append(val_)
            else:
                c["t_last"] = smax(c["t_last"], idx_, val_)
            return c

        # ---- next event: earliest arrival vs earliest iteration end ----
        ap = c["aptr"]
        ta = torch.where(f(ap) < A, g1(t_arr, rc(ap)), inf)
        se = c["t_next"].argmin(1)
        tsv = g1(c["t_next"], se)
        now = torch.minimum(ta, tsv)
        active = (now <= h_eff) & run
        if frontier is not None:
            # streamed replay: an event at/after the next chunk's splice
            # point could interact with arrivals not loaded yet
            active = active & (now < frontier)
        is_arr = active & (ta <= tsv)  # arrivals first on ties
        is_iter = active & ~is_arr

        # ---- arrival: advance the cursor, push to the class queue ------
        ca = g1(cls, rc(ap))
        c = st_max(c, rc(ap), torch.where(is_arr, _QUEUED, -1))
        # int + bool: the count of the one-hot
        c["qarr"] = c["qarr"] + (is_arr[:, None] & (iota_I == ca[:, None]))
        c["aptr"] = ap + is_arr

        # ---- iteration end on server `se` -------------------------------
        at_se = sid == se[:, None]
        end = at_se & is_iter[:, None]
        c["busy"] = c["busy"] & ~end
        c["t_next"] = torch.where(end, inf, c["t_next"])
        # 1) snapshot decodes emit one token each (clip-aliased empty
        #    slots contribute identities, never clobbers)
        row = c["slot_rid"][ar, se]
        rr = rc(row)
        live = is_iter[:, None] & (row >= 0) & c["slot_live"][ar, se]
        if dense_tout:  # per-slot counter: zero request-axis traffic
            tout_new = c["slot_tout"][ar, se] + 1.0
            c["slot_tout"] = c["slot_tout"] + f(at_se[:, :, None]
                                                & live[:, None, :])
        else:
            tout_new = c["tout"].gather(1, rr) + 1.0  # distinct live rids
            # 0/1 adds: exact in any order
            c["tout"] = c["tout"].scatter_add(1, rr, f(live))
        c = mark_first(c, rr, torch.where(live, now[:, None], inf))
        c = mark_last(c, rr, torch.where(live, now[:, None], -inf))
        D_rr = D.gather(1, rr)
        done = live & (tout_new >= D_rr)
        if charging == "separate":
            reward = c_d[:, None] * D_rr
        else:
            reward = c_p[:, None] * P.gather(1, rr) + c_d[:, None] * D_rr
        c["rev"] = c["rev"] + torch.where(done, reward, 0.0).sum(1)
        c = st_max(c, rr, torch.where(done, _DONE, -1))
        if "srv" in c:
            c["srv"] = smin(c["srv"], rr,
                            torch.where(done, -1, _INT32_MAX))
        done_row = at_se[:, :, None] & done[:, None, :]
        c["slot_rid"] = torch.where(done_row, -1, c["slot_rid"])
        c["slot_live"] = c["slot_live"] & ~done_row
        # 2) prefill-chunk progress + routing of a finished prefill
        pf = g1(c["pf_rid"], se)
        has_pf = is_iter & (pf >= 0)
        pfc = rc(pf)
        ch_se = g1(c["chunk"], se)
        pln = g1(c["pf_left"], se) - ch_se
        c["pf_left"] = c["pf_left"] - torch.where(
            at_se & has_pf[:, None], ch_se[:, None], 0.0)
        pf_done = has_pf & (pln <= 0)
        if charging == "separate":
            c["rev"] = c["rev"] + torch.where(pf_done, c_p * g1(P, pfc),
                                              0.0)
        if need_tbuf:
            c["t_buf"] = sset(c["t_buf"], pfc, torch.where(
                pf_done, now, g1(c["t_buf"], pfc)))
        c = st_max(c, pfc, torch.where(pf_done, _BUF, -1))
        cls_pf = g1(cls, pfc)
        c["X"] = c["X"] - f(pf_done[:, None] & (iota_I == cls_pf[:, None]))
        c["pf_rid"] = torch.where(at_se & pf_done[:, None], -1, c["pf_rid"])
        if router_kind == "randomized":
            go_solo = u[:, 0] <= g1(params["p_solo"], cls_pf)
            c["pool"] = sset(c["pool"], pfc, torch.where(
                pf_done, torch.where(go_solo, 0, 1), g1(c["pool"], pfc)))
            if not has_pw:  # pool FCFS rings
                for pid, ring in ((0, "buf_s"), (1, "buf_m")):
                    push = pf_done & (g1(c["pool"], pfc) == pid)
                    tl = c[f"{ring}_tl"]
                    c[ring] = smax(c[ring], tl, torch.where(push, pf, -1))
                    c[f"{ring}_tl"] = tl + push
        elif router_kind == "immediate":
            # stays pending on `se`: mark the target in srv
            c["srv"] = sset(c["srv"], pfc, torch.where(
                pf_done, se, g1(c["srv"], pfc)))
        else:  # single global FCFS ring (solo_first / local_fcfs)
            tl = c["buf_tl"]
            if multi:
                # defer the ring write; `buf_tl` advances immediately and
                # in-block pops overlay the pending pushes below
                dfr["push_i"].append(tl)
                dfr["push_v"].append(torch.where(pf_done, pf, -1))
            else:
                c["buf"] = smax(c["buf"], tl, torch.where(pf_done, pf, -1))
            c["buf_tl"] = tl + pf_done

        # 3) decode dispatch
        busy_pre = c["busy"]  # dispatch-time idleness (se already cleared)
        if router_kind in ("solo_first", "local_fcfs"):
            hd, tl = c["buf_hd"], c["buf_tl"]
            RL = c["buf"].shape[1]
            pos_w = hd[:, None] + iota_W
            win = c["buf"].gather(
                1, torch.clamp(hd, 0, RL - W)[:, None] + iota_W)
            if multi:  # overlay this block's not-yet-flushed ring pushes
                for ti, tv in zip(dfr["push_i"], dfr["push_v"]):
                    win = torch.where(pos_w == ti[:, None],
                                      torch.maximum(win, tv[:, None]), win)
            jw_ = rc(win)
            valid = (pos_w < tl[:, None]) & is_iter[:, None]
            if expiry:
                expired = valid & (now[:, None] - c["t_buf"].gather(1, jw_)
                                   > patience.gather(1, jw_))
            else:  # patience == inf everywhere: nothing ever expires
                expired = torch.zeros_like(valid)
            pe = valid & ~expired  # placeable
            fpe = f(pe)
            erank = torch.cumsum(fpe, 1) - fpe  # exclusive FCFS rank
            free = torch.clamp_min(cap_of(c["pf_rid"])
                                   - used_of(c["slot_rid"]), 0.0)
            cumfree = torch.cumsum(free.gather(1, perm_srv), 1)
            totfree = cumfree[:, -1:]
            consumed = valid & (erank < totfree)
            place = pe & (erank < totfree)
            pos = torch.searchsorted(cumfree, erank, right=True)
            server = perm_srv.gather(1, torch.clamp(pos, 0, n - 1))
            within = erank - torch.where(
                pos > 0, cumfree.gather(1, torch.clamp_min(pos - 1, 0)), 0.0)
            # k-th empty physical slot of each server (a stable sort puts
            # empty slots first, in index order)
            esort = torch.sort((c["slot_rid"] >= 0).to(torch.uint8), dim=2,
                               stable=True).indices
            slot = esort.reshape(nr, nB).gather(
                1, server * B + torch.clamp(within.to(torch.int64), 0, B - 1))
            flat = server * B + slot
            c["slot_rid"] = on_slots(c["slot_rid"], smax, flat,
                                     torch.where(place, win, -1))
            if dense_tout:  # fresh occupant: reset the per-slot counter
                c["slot_tout"] = on_slots(c["slot_tout"], smin, flat,
                                          torch.where(place, 0.0, inf))
            c = st_max(c, jw_, torch.where(
                place, _DECODE, torch.where(consumed & expired,
                                            _ABANDONED, -1)))
            c["buf_hd"] = hd + consumed.sum(1)
            c["abandons"] = c["abandons"] + f(consumed & expired).sum(1)
            # the reference's zeros(n, bool).at[server].max(place): a count
            # of placements per server, then > 0 (integer adds: exact)
            placed_srv = torch.zeros((nr, n), dtype=torch.int64,
                                     device=dev).scatter_add(
                1, server, place.to(torch.int64)) > 0
        elif router_kind == "immediate":
            # pending jobs live as BUF with srv == se; FCFS by t_buf
            placed_any = torch.zeros_like(is_iter)
            for _ in range(W):
                cap_se = g1(cap_of(c["pf_rid"]), se)
                used_se = g1(used_of(c["slot_rid"]), se)
                elig = (c["st"] == _BUF) & (c["srv"] == se[:, None])
                j = torch.where(elig, c["t_buf"], inf).argmin(1)
                do = is_iter & elig.any(1) & (used_se < cap_se)
                expired = now - g1(c["t_buf"], j) > g1(patience, j)
                c["st"] = smax(c["st"], j, torch.where(do & expired,
                                                       _ABANDONED, -1))
                c["abandons"] = c["abandons"] + f(do & expired)
                c = place_into(c, se, j, do & ~expired)
                placed_any = placed_any | (do & ~expired)
            placed_srv = at_se & placed_any[:, None]
        else:  # randomized: solo pool drains first; uniform server draw
            solo_srv = sid >= Mi
            placed_srv = torch.zeros_like(at_se)
            for k in range(W):
                u1, u2 = u[:, 2 * k + 1], u[:, 2 * k + 2]
                free = cap_of(c["pf_rid"]) - used_of(c["slot_rid"]) > 0
                free_s = solo_srv & free
                free_m = ~solo_srv & free
                if has_pw:  # EC.7 class weights need an in-buffer scan
                    is_buf = c["st"] == _BUF
                    elig_s = is_buf & (c["pool"] == 0)
                    elig_m = is_buf & (c["pool"] == 1)
                    can_s = free_s.any(1) & elig_s.any(1)
                    use_solo = can_s
                    do = is_iter & (can_s | (free_m.any(1) & elig_m.any(1)))
                    pool_elig = torch.where(use_solo[:, None], elig_s, elig_m)
                    j_fcfs = torch.where(pool_elig, c["t_buf"], inf).argmin(1)
                    pw = torch.where(use_solo[:, None], params["pw_s"],
                                     params["pw_m"])
                    # 0/1 counts: exact in any order
                    present = torch.zeros((nr, I), dtype=dtype,
                                          device=dev).scatter_add(
                        1, cls, f(pool_elig)) > 0
                    w = torch.clamp_min(pw, 0.0) * f(present)
                    ci = _categorical(u1, w)
                    j_w = torch.where(pool_elig & (cls == ci[:, None]),
                                      c["t_buf"], inf).argmin(1)
                    j = torch.where(w.sum(1) > 0, j_w, j_fcfs)
                    pop = do & (g1(c["st"], j) == _BUF)  # no-op lanes
                    expired = now - g1(c["t_buf"], j) > g1(patience, j)
                    c["st"] = smax(c["st"], j, torch.where(pop & expired,
                                                           _ABANDONED, -1))
                else:  # plain pool FCFS: ring heads
                    hd_s, hd_m = c["buf_s_hd"], c["buf_m_hd"]
                    can_s = free_s.any(1) & (hd_s < c["buf_s_tl"])
                    can_m = free_m.any(1) & (hd_m < c["buf_m_tl"])
                    use_solo = can_s
                    do = is_iter & (can_s | can_m)
                    j = torch.where(use_solo, g1(c["buf_s"], rc(hd_s)),
                                    g1(c["buf_m"], rc(hd_m)))
                    pop = do
                    c["buf_s_hd"] = hd_s + (pop & use_solo)
                    c["buf_m_hd"] = hd_m + (pop & ~use_solo)
                    if expiry:
                        expired = (now - g1(c["t_buf"], rc(j))
                                   > g1(patience, rc(j)))
                    else:
                        expired = torch.zeros_like(pop)
                    c["st"] = smax(c["st"], rc(j), torch.where(
                        pop & expired, _ABANDONED, -1))
                pool_free = torch.where(use_solo[:, None], free_s, free_m)
                sv = _categorical(u2, f(pool_free))
                c["abandons"] = c["abandons"] + f(pop & expired)
                c = place_into(c, sv, j, pop & ~expired)
                placed_srv = placed_srv | ((sid == sv[:, None])
                                           & (pop & ~expired)[:, None])

        # 4) at most one prefill admission (gate family invariant)
        class_rids = params["class_rids"]

        def heads_of(qhead):
            return class_rids.gather(2, rc(qhead)[:, :, None])[:, :, 0]

        heads = heads_of(c["qhead"])
        qlen = f(c["qarr"] - c["qhead"])
        if expiry:
            # lazy head expiry (at most one head per class per event)
            rh = rc(heads)
            hexp = (active[:, None] & (qlen > 0)
                    & (now[:, None] - t_arr.gather(1, rh)
                       > patience.gather(1, rh)))
            c = st_max(c, rh, torch.where(hexp, _ABANDONED, -1))
            c["qhead"] = c["qhead"] + hexp
            c["abandons"] = c["abandons"] + f(hexp).sum(1)
            heads = heads_of(c["qhead"])
            qlen = f(c["qarr"] - c["qhead"])

        used2 = used_of(c["slot_rid"])
        no_pf = c["pf_rid"] < 0
        if partition == "none":
            if router_kind == "immediate":
                pend = _count_pending(c, n, dtype)
                canp = no_pf & (used2 + pend < Bp)
            else:
                canp = no_pf & (used2 < Bp)
            if sarathi:
                canp = canp & (used2 < Bp - 1)
        else:
            mixed = sid < Mi
            if router_kind == "immediate":
                pend = _count_pending(c, n, dtype)
                capm = (torch.zeros_like(used2) if prefill_only
                        else Bp.expand(nr, n))
                canp = mixed & no_pf & (used2 + pend < capm)
            else:
                canp = mixed & no_pf & (used2 <= Bp - 1)
        canp = canp & active[:, None]
        tgt = torch.where(canp, sid, 2 * n).argmin(1)  # first free server
        if gate_kind == "occupancy":
            gmask = (qlen >= 1) & (x_star > _EPS_TARGET)
            xi = ((c["X"] + 1.0 - n_f[:, None] * x_star)
                  / torch.clamp_min(x_star, 1e-30))
            keyv = torch.where(gmask, xi, inf)
            tie = gmask & (keyv == keyv.amin(1, keepdim=True))
            delta = qlen - n_f[:, None] * qp_star
            cand = torch.where(tie, delta, -inf).argmax(1)
            can = gmask.any(1)
        elif gate_kind == "priority":
            gmask = qlen >= 1
            cand = torch.where(gmask, params["ratio"], -inf).argmax(1)
            can = gmask.any(1)
        else:  # fcfs: exact head-of-line class (oldest waiting request)
            cand = torch.where(qlen >= 1, heads, R).argmin(1)
            can = (qlen >= 1).any(1)
        admit = canp.any(1) & can
        jr = g1(heads, cand)
        c = st_max(c, rc(jr), torch.where(admit, _PREFILL, -1))
        if "srv" in c:
            c["srv"] = sset(c["srv"], rc(jr), torch.where(
                admit, tgt, g1(c["srv"], rc(jr))))
        adm_i = admit[:, None] & (iota_I == cand[:, None])
        c["qhead"] = c["qhead"] + adm_i
        c["X"] = c["X"] + f(adm_i)
        adm_s = admit[:, None] & (sid == tgt[:, None])
        c["pf_rid"] = torch.where(adm_s, jr[:, None], c["pf_rid"])
        c["pf_left"] = torch.where(adm_s, g1(P, rc(jr))[:, None],
                                   c["pf_left"])

        # flush the deferred lifecycle transitions in ONE scatter-max
        # (codes are ordered along the lifecycle, so max composes)
        if fast_st and not multi:
            c["st"] = smax(c["st"], torch.cat(st_idx, 1),
                           torch.cat(st_val, 1))

        # single wake pass, post-admission (the Python engine's step-5
        # order); a server dispatch woke while idle that then drew the
        # admission starts decode-only
        force_solo = (placed_srv & ~busy_pre & admit[:, None]
                      & (sid == tgt[:, None]))
        c = wake(c, now, active, force_solo, used2)  # slots unchanged

        c["t"] = torch.where(active, now, c["t"])
        c["n_iters"] = c["n_iters"] + f(is_iter)
        c["n_events"] = c["n_events"] + f(active)
        # early-exit flag: is another event pending before the horizon?
        ta2 = torch.where(f(c["aptr"]) < A, g1(t_arr, rc(c["aptr"])), inf)
        c["alive"] = torch.minimum(ta2, c["t_next"].amin(1)) <= h_eff
        return c

    def step(carry, run, U=None):
        c = dict(carry)
        c["n_loop"] = c["n_loop"] + f(c["alive"] & run)
        if fastforward:
            c = ffwd(c, run)
        if not multi:
            return event(c, run, None if U is None else U[:, 0], None)
        dfr = {k2: [] for k2 in ("st_i", "st_v", "tf_i", "tf_v",
                                 "tl_i", "tl_v", "push_i", "push_v")}
        for j in range(k_events):
            c = event(c, run, None if U is None else U[:, j], dfr)
        # one combined flush per (R,) array for the whole block: max/min
        # compose across events exactly like across transitions
        if fast_st:
            c["st"] = smax(c["st"], torch.cat(dfr["st_i"], 1),
                           torch.cat(dfr["st_v"], 1))
            c["buf"] = smax(c["buf"], torch.stack(dfr["push_i"], 1),
                            torch.stack(dfr["push_v"], 1))
        c["t_first"] = smin(c["t_first"], torch.cat(dfr["tf_i"], 1),
                            torch.cat(dfr["tf_v"], 1))
        c["t_last"] = smax(c["t_last"], torch.cat(dfr["tl_i"], 1),
                           torch.cat(dfr["tl_v"], 1))
        return c

    if tlm is None:
        return step
    return wrap_engine_step_probes(step, tlm, params)


def _count_pending(c, n, dtype):
    """Pending-local counts for the immediate router (an O(R) pass; only
    built into the immediate variant).  0/1 adds: exact in any order."""
    return torch.zeros((c["st"].shape[0], n), dtype=dtype,
                       device=c["st"].device).scatter_add(
        1, torch.clamp(c["srv"], 0, n - 1), (c["st"] == _BUF).to(dtype))


def _init_carry(R: int, n: int, B: int, I: int, dtype, router_kind: str,
                has_pw: bool, expiry: bool, k_events: int = 1,
                fastforward: bool = False, telemetry=None, *, nr: int = 1,
                device=None) -> dict:
    """The fresh carry of ``nr`` replications (leading axis)."""
    W = B + 1
    i64 = torch.int64

    def full(shape, v, dt):
        return torch.full((nr,) + tuple(shape), v, dtype=dt, device=device)

    c = {
        "st": full((R,), 0, i64),
        "tout": full((R,), 0.0, dtype),
        "t_first": full((R,), math.inf, dtype),
        "t_last": full((R,), -math.inf, dtype),  # max-scatter identity
        "slot_rid": full((n, B), -1, i64),
        "slot_live": full((n, B), False, torch.bool),
        "pf_rid": full((n,), -1, i64),
        "pf_left": full((n,), 0.0, dtype),
        "busy": full((n,), False, torch.bool),
        "t_next": full((n,), math.inf, dtype),
        "chunk": full((n,), 0.0, dtype),
        "aptr": full((), 0, i64),
        "qhead": full((I,), 0, i64),
        "qarr": full((I,), 0, i64),
        "X": full((I,), 0.0, dtype),
        "t": full((), 0.0, dtype),
        "rev": full((), 0.0, dtype),
        "n_iters": full((), 0.0, dtype),
        "n_events": full((), 0.0, dtype),
        "n_loop": full((), 0.0, dtype),  # loop steps (batching factor)
        "abandons": full((), 0.0, dtype),
        "alive": full((), True, torch.bool),
    }
    if (expiry or router_kind == "immediate"
            or (router_kind == "randomized" and has_pw)):
        c["t_buf"] = full((R,), math.inf, dtype)
    if router_kind in ("solo_first", "local_fcfs"):
        # +W slack so the dispatch window never clamps its start index
        c["buf"] = full((R + W,), -1, i64)
        c["buf_hd"] = full((), 0, i64)
        c["buf_tl"] = full((), 0, i64)
        if k_events > 1 or fastforward:
            del c["tout"]  # dense per-slot token counter instead
            c["slot_tout"] = full((n, B), 0.0, dtype)
    elif router_kind == "randomized" and not has_pw:
        for ring in ("buf_s", "buf_m"):
            c[ring] = full((R + W,), -1, i64)
            c[f"{ring}_hd"] = full((), 0, i64)
            c[f"{ring}_tl"] = full((), 0, i64)
    if router_kind == "immediate":
        c["srv"] = full((R,), -1, i64)
    if router_kind == "randomized":
        c["pool"] = full((R,), -1, i64)
    if telemetry is not None:
        # fixed-shape probe arrays under tlm_ keys: _summary never reads
        # them, so the non-telemetry outputs are unchanged
        c.update(probe_carry(telemetry, n=n, I=I, dtype=dtype, batch=(nr,),
                             device=device))
    return c


def _fill_latency_hists(carry: dict, t_arr, spec) -> dict:
    """Bucket the per-request latency marks into ``tlm_ttft``/``tlm_e2e``
    once after the loop (the reference's ``_fill_latency_hists``): TTFT =
    ``t_first - t_arr``, E2E = ``t_last - t_arr`` of ``_DONE`` rows.
    Rows that never emitted carry zero weight; their NaN/out-of-band
    differences still land on a valid bucket.  0/1 adds: exact."""
    dt = t_arr.dtype
    edges = torch.as_tensor(hist_edges(spec), dtype=dt, device=t_arr.device)
    c = dict(carry)
    hb = torch.searchsorted(edges, c["t_first"] - t_arr)
    c["tlm_ttft"] = c["tlm_ttft"].scatter_add(
        1, hb, torch.isfinite(c["t_first"]).to(dt))
    hb = torch.searchsorted(edges, c["t_last"] - t_arr)
    c["tlm_e2e"] = c["tlm_e2e"].scatter_add(1, hb, (c["st"] == _DONE).to(dt))
    return c


# ------------------------------------------------------------------ the loop
class _Blocks:
    """Runs a step in blocks of :data:`BLOCK_STEPS` steps until no
    replication's loop condition holds (or for ``fixed_blocks`` blocks,
    the strict ``scan`` form).  On the card each block is one replay of
    a CUDA graph.

    A block reads the carry, ``i`` (nr,) the loop counter, and ``aux``
    (the condition's tensors: the block budget, or the segment budget);
    ``cond(c, i, aux)`` gives the run mask of a step, and after a step
    ``i += run``."""

    # graphs by (statics, shapes, mode); a capture holds its buffers
    _cache: "OrderedDict[tuple, dict]" = OrderedDict()
    _CACHE_MAX = 8

    def __init__(self, statics: dict, cond):
        self.statics = statics
        self.cond = cond
        self.block = BLOCK_STEPS

    def _body(self, params, keys, c, i, aux):
        st = self.statics
        step = _build_step(params, **st)
        randomized = st["router_kind"] == "randomized"
        k = st["k_events"]
        U = None
        if randomized:
            # the block's uniforms in one draw: step j of the block is the
            # (i0 + j)-th step of every replication still running, since
            # a replication's condition never turns true again
            U = _uniforms(keys, i * k, self.block * k, 2 * st["B"] + 3,
                          params["t_arr"].dtype)
        for j in range(self.block):
            run = self.cond(c, i, aux)
            c = step(c, run, None if U is None
                     else U[:, j * k:(j + 1) * k])
            i = i + run.to(i.dtype)
        return c, i, self.cond(c, i, aux).any()

    def __call__(self, params, keys, carry, i, aux, *, fixed_blocks=None):
        dev = params["t_arr"].device
        if dev.type == "cuda":
            body = self._graphed(params, keys, carry, i, aux)
        else:
            def body():
                nonlocal carry, i
                carry, i, more = self._body(params, keys, carry, i, aux)
                return more
        done = 0
        while fixed_blocks is None or done < fixed_blocks:
            more = body()
            done += 1
            if fixed_blocks is None and not bool(more):
                break
        if dev.type == "cuda":
            carry = {k: v.clone() for k, v in self._bufs["carry"].items()}
            i = self._bufs["i"].clone()
        return carry, i

    def _graphed(self, params, keys, carry, i, aux):
        """The block as a CUDA graph over static buffers, captured once
        per statics and shapes; this call's inputs are copied in."""
        sig = lambda d: tuple(sorted((k, tuple(v.shape), v.dtype)  # noqa
                                     for k, v in d.items()))
        key = (tuple(sorted((k, str(v)) for k, v in self.statics.items())),
               self.block, id(self.cond), sig(params), sig(carry),
               sig(aux), tuple(keys.shape), str(params["t_arr"].device))
        ent = self._cache.get(key)
        if ent is None:
            ent = self._capture(params, keys, carry, i, aux)
            self._cache[key] = ent
            while len(self._cache) > self._CACHE_MAX:
                self._cache.popitem(last=False)
        self._cache.move_to_end(key)
        bufs = ent["bufs"]
        for name, src in (("params", params), ("carry", carry),
                          ("aux", aux)):
            for k, v in src.items():
                bufs[name][k].copy_(v)
        bufs["keys"].copy_(keys)
        bufs["i"].copy_(i)
        self._bufs = bufs
        graph, more = ent["graph"], ent["more"]

        def body():
            graph.replay()
            run.graph_replays += 1
            return more

        return body

    def _capture(self, params, keys, carry, i, aux):
        bufs = {"params": {k: v.clone() for k, v in params.items()},
                "carry": {k: v.clone() for k, v in carry.items()},
                "aux": {k: v.clone() for k, v in aux.items()},
                "keys": keys.clone(), "i": i.clone()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # one eager block on copies first: lazy library set-up must
            # not happen inside the capture
            self._body(bufs["params"], bufs["keys"],
                       {k: v.clone() for k, v in bufs["carry"].items()},
                       bufs["i"].clone(), bufs["aux"])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            c, i2, more = self._body(bufs["params"], bufs["keys"],
                                     bufs["carry"], bufs["i"], bufs["aux"])
            for k, v in c.items():
                if v is not bufs["carry"][k]:
                    bufs["carry"][k].copy_(v)
            bufs["i"].copy_(i2)
        return {"graph": graph, "bufs": bufs, "more": more}


def _cond_while(c, i, aux):
    return c["alive"] & (i < aux["n_blocks"])


def _cond_scan(c, i, aux):
    return i < aux["n_blocks"]


def _cond_segment(c, i, aux):
    """The streamed segment loop's condition: an event pending at or
    before the horizon, strictly before the frontier, within budget."""
    p = aux
    Rw = p["t_arr"].shape[1]
    ta = torch.where(c["aptr"].to(p["t_arr"].dtype) < p["A"],
                     p["t_arr"].gather(1, torch.clamp(
                         c["aptr"], 0, Rw - 1)[:, None])[:, 0], math.inf)
    tmin = torch.minimum(ta, c["t_next"].amin(1))
    return (tmin <= p["h_eff"]) & (tmin < p["frontier"]) & (i < p["budget"])


def _batched(params: dict, nr: int, multi: bool) -> dict:
    """Params with the leading replication axis (``multi``: already
    there, one instance a row; else shared, expanded as views)."""
    if multi:
        for k, v in params.items():
            if v.shape[:1] != (nr,):
                raise ValueError(f"multi: params[{k!r}] has leading shape "
                                 f"{tuple(v.shape[:1])}, need ({nr},)")
        return dict(params)
    return {k: v.unsqueeze(0).expand((nr,) + tuple(v.shape))
            for k, v in params.items()}


def _run_core(params, keys, *, n_steps, n, B, gate_kind, router_kind,
              charging, partition, sarathi, unchunked, prefill_only, has_pw,
              expiry, loop="while", model_kind="affine", k_events=1,
              fastforward=False, telemetry=None, multi=False):
    """Replay every replication of the batch: ``keys`` (nr, 2); returns
    the carry, leading axis nr."""
    nr = keys.shape[0]
    P = _batched(params, nr, multi)
    t_arr = P["t_arr"]
    dev = t_arr.device
    keys = keys.to(dev)
    R, I = t_arr.shape[1], P["x_star"].shape[1]
    statics = dict(n=n, B=B, gate_kind=gate_kind, router_kind=router_kind,
                   charging=charging, partition=partition, sarathi=sarathi,
                   unchunked=unchunked, prefill_only=prefill_only,
                   has_pw=has_pw, expiry=expiry, model_kind=model_kind,
                   k_events=k_events, fastforward=fastforward,
                   telemetry=telemetry)
    carry = _init_carry(R, n, B, I, t_arr.dtype, router_kind, has_pw, expiry,
                        k_events, fastforward, telemetry, nr=nr, device=dev)
    # the loop iterates over k-event BLOCKS of the reference; a final
    # partial block runs its overhang as proven no-op events
    n_blocks = -(-int(n_steps) // int(k_events))
    aux = {"n_blocks": torch.tensor(n_blocks, device=dev)}
    i0 = torch.zeros(nr, dtype=torch.int64, device=dev)
    if loop == "scan":  # strict fixed-length form: every block runs
        blocks = _Blocks(statics, _cond_scan)
        carry, _ = blocks(P, keys, carry, i0, aux,
                          fixed_blocks=-(-n_blocks // blocks.block))
    else:  # early exit once no replication has an event pending
        blocks = _Blocks(statics, _cond_while)
        carry, _ = blocks(P, keys, carry, i0, aux)
    if telemetry is not None:
        carry = _fill_latency_hists(carry, t_arr, telemetry)
    return carry


def _keys2d(keys) -> torch.Tensor:
    k = torch.as_tensor(keys)
    return k[None] if k.dim() == 1 else k


@torch.inference_mode()
def run_engine(params, key, **statics) -> dict:
    """One replication: the carry without a leading axis."""
    out = _run_core(params, _keys2d(key), **statics)
    return {k: v[0] for k, v in out.items()}


@torch.inference_mode()
def run_engine_batch(params, keys, **statics) -> dict:
    """A replication batch over a leading axis of keys (the reference's
    ``vmap`` of :func:`run_engine`)."""
    return _run_core(params, _keys2d(keys), **statics)


@torch.inference_mode()
def run_engine_multi(params, keys, **statics) -> dict:
    """A batch over a leading *instance* axis of params AND keys (DistServe
    split scans, equal-shape traces in lockstep, perturbed primitives);
    statics must match."""
    return _run_core(params, _keys2d(keys), multi=True, **statics)


@torch.inference_mode()
def _run_segment(params, key, carry, i0, budget, **statics):
    """Run engine steps from ``carry`` until the chunk frontier, the
    horizon or the step budget -- the streamed-replay segment loop
    (:class:`repro_torch.serving.engine_stream.StreamingEngineJAX` drives
    it between working-set splices).  One replication, unbatched carry;
    returns ``(carry, i)``."""
    P = _batched(params, 1, False)
    dev = P["t_arr"].device
    c = {k: v.unsqueeze(0) for k, v in carry.items()}
    aux = {"t_arr": P["t_arr"], "A": P["A"], "h_eff": P["h_eff"],
           "frontier": P["frontier"],
           "budget": torch.as_tensor(budget, device=dev).reshape(1)}
    blocks = _Blocks(statics, _cond_segment)
    c, i = blocks(P, _keys2d(key).to(dev), c,
                  torch.as_tensor(i0, device=dev).reshape(1), aux)
    return {k: v[0] for k, v in c.items()}, i[0]


def _as_keys(keys):
    """Normalize one-or-many seed specs (ints or key tensors)."""
    if isinstance(keys, (list, tuple)):
        return torch.stack([prng_key(int(k))
                            if isinstance(k, (int, np.integer))
                            else torch.as_tensor(k) for k in keys])
    if isinstance(keys, (int, np.integer)):
        return prng_key(int(keys))
    return torch.as_tensor(keys)


def run(params, keys, *, placement: str = "vmap", multi: bool = False,
        segment=None, **statics):
    """Unified entry for every way this engine executes (the reference's
    facade):

    * ``placement="single"``  one replication (``keys`` is one seed or
      key);
    * ``placement="vmap"``    a replication batch (``keys`` a
      sequence/stack), the port's batched step;
    * ``placement="shard_map"`` comes with the sweep layer (ROADMAP A8)
      and raises until then;
    * ``multi=True``          the leading *instance* axis of ``params``
      rides with ``keys``;
    * ``segment=(carry, i0, budget)`` the streamed-replay segment mode
      (placement ``"single"``; ``statics`` exclude ``n_steps``/``loop``).

    ``statics`` are :attr:`ClusterEngineJAX.statics`."""
    keys = _as_keys(keys)
    if segment is not None:
        if placement != "single" or multi:
            raise ValueError("segment mode is single-placement only")
        carry, i0, budget = segment
        return _run_segment(params, keys, carry, i0, budget, **statics)
    if placement == "single":
        if multi:
            raise ValueError("multi needs a batch placement (vmap|shard_map)")
        return run_engine(params, keys, **statics)
    if placement == "vmap":
        return (run_engine_multi if multi
                else run_engine_batch)(params, keys, **statics)
    if placement == "shard_map":
        raise NotImplementedError(
            "placement='shard_map' needs sweep/sharded.py, which is not "
            "ported yet (ROADMAP A8); use 'vmap'")
    raise ValueError(f"unknown placement {placement!r} (expected "
                     f"single|vmap|shard_map)")


#: CUDA-graph replays of the loop's blocks, all calls together (the
#: loop's launches on the card; the CPU route replays nothing)
run.graph_replays = 0


def _host(raw: dict) -> dict:
    """A raw carry (tensors on any device, or numpy arrays) on the host."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in raw.items()}


class ClusterEngineJAX:
    """Batched trace-replay twin of :class:`ClusterEngine` (the
    reference's class of the same name).

    Same classes/policy/:class:`EngineConfig` inputs and summary keys; the
    trace and horizon are fixed at construction (they set the tensor
    shapes and the step budget) and replications run as one batch over
    generator keys.  ``max_steps`` caps the budget (``budget_exhausted``
    reports a truncated replay), ``max_requests`` caps the tensorized
    trace, ``k_events`` unrolls k events per step, ``fastforward``
    retires non-interacting events in closed form.  ``dtype`` (float32
    by default, as the reference runs without ``x64``) and ``device``
    (the card unless ``"cpu"`` is passed) say where and how precisely the
    replay runs.
    """

    def __init__(self, classes: Sequence[WorkloadClass], policy: PolicySpec,
                 cfg: EngineConfig, trace, horizon: float, *,
                 drain: bool = False, max_steps: Optional[int] = None,
                 max_requests: Optional[int] = None, loop: str = "while",
                 k_events: int = 1, fastforward: bool = False,
                 telemetry=None, dtype=torch.float32, device=None):
        if loop not in ("while", "scan"):
            raise ValueError(f"loop must be while|scan, got {loop!r}")
        if int(k_events) < 1:
            raise ValueError(f"k_events must be >= 1, got {k_events!r}")
        if cfg.record_queues_every > 0:
            raise ValueError("engine_jax does not record queue traces; "
                             "use the Python ClusterEngine")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.classes = tuple(classes)
        self.I = len(self.classes)
        self.policy = policy
        self.cfg = cfg
        self.n = int(cfg.n_servers)
        prim = cfg.prim

        tt = (trace if isinstance(trace, TraceTensors)
              else tensorize_trace(trace, max_requests=max_requests))
        self.trace = tt
        if tt.n_real and int(tt.cls[tt.valid].max()) >= self.I:
            raise ValueError(
                f"trace references class {int(tt.cls[tt.valid].max())} but "
                f"only {self.I} classes were given")

        # horizon semantics of ClusterEngine.run: stop at the last prompt
        # arrival unless draining (paper Section 6.2 convention)
        arr_t = tt.t[tt.valid & (tt.t <= horizon)]
        last_arrival = float(arr_t.max()) if arr_t.size else float(horizon)
        self.h_eff = float(horizon) if drain else min(float(horizon),
                                                      last_arrival)
        arrived = tt.valid & (tt.t <= self.h_eff)

        self.budget = iteration_budget(tt, cfg, self.h_eff, arrived=arrived)
        self.n_steps = (self.budget if max_steps is None
                        else min(self.budget, int(max_steps)))

        self.gate_kind = _gate_kind(policy)
        if policy.router not in ("solo_first", "local_fcfs", "immediate",
                                 "randomized"):
            raise ValueError(f"unknown router {policy.router!r}")
        self.router_kind = policy.router
        if fastforward and policy.router not in ("solo_first",
                                                 "local_fcfs"):
            raise ValueError(
                "fastforward needs a deterministic global-buffer router "
                f"(solo_first/local_fcfs), got {policy.router!r}")
        self.partition = "none" if policy.partition == "none" else "static"
        self.M = int(policy.mixed_target(self.n))
        pw_m, pw_s = policy.pool_weights_mixed, policy.pool_weights_solo
        if (pw_m is None) != (pw_s is None):
            raise ValueError("engine_jax needs both pool-weight vectors "
                             "or neither")
        self.has_pw = pw_m is not None

        # per-class FCFS tables: class i's rids in arrival order (a class
        # queue is then a [qhead, qarr) window over its table row)
        class_rids = np.full((self.I, tt.R), tt.R, dtype=np.int64)
        for i in range(self.I):
            rids = np.nonzero(arrived & (tt.cls == i))[0]
            class_rids[i, : rids.size] = rids

        # static routing order: solo servers first for solo_first
        sids = np.arange(self.n, dtype=np.int64)
        if self.router_kind == "solo_first":
            perm_srv = np.concatenate([sids[self.M:], sids[: self.M]])
        else:
            perm_srv = sids

        dev = self.device
        ones = np.ones(self.I)

        def a(v):
            return torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   dtype=dtype, device=dev)

        def ix(v):
            return torch.as_tensor(np.asarray(v, dtype=np.int64), device=dev)

        gate = policy.gate
        self.params = {
            "t_arr": a(np.where(arrived, tt.t, np.inf)),
            "cls": ix(tt.cls),
            "P": a(tt.P),
            "D": a(tt.D),
            "patience": a(tt.patience),
            "class_rids": ix(class_rids),
            "A": a(int(arrived.sum())),
            "x_star": a(gate.x_star if isinstance(gate, OccupancyGate)
                        else ones),
            "qp_star": a(gate.qp_star if isinstance(gate, OccupancyGate)
                         else 0 * ones),
            "ratio": a(gate.ratio if isinstance(gate, PriorityRatioGate)
                       else ones),
            "p_solo": a(policy.solo_prob if policy.solo_prob is not None
                        else ones),
            "pw_m": a(pw_m if pw_m is not None else ones),
            "pw_s": a(pw_s if pw_s is not None else ones),
            "c_p": a(cfg.pricing.c_p),
            "c_d": a(cfg.pricing.c_d),
            "alpha": a(prim.alpha),
            "beta": a(prim.beta),
            "tau_solo": a(prim.tau_solo),
            "b_s": a(cfg.solo_kv_slope),
            "kv_xfer": a(0.0),
            "B": a(prim.batch_cap),
            "C": a(prim.chunk),
            "Mi": ix(self.M),
            "perm_srv": ix(perm_srv),
            "n_f": a(self.n),
            "h_eff": a(self.h_eff),
        }
        # plugged iteration-time model (repro_torch.calibration protocol):
        # affine-kind models override the four surface scalars; table-kind
        # models add knot arrays and flip the interp dispatch
        self.model_kind = "affine"
        m = cfg.iter_model
        if m is not None:
            self.model_kind = getattr(m, "kind", "affine")
            if self.model_kind == "table":
                for k, v in m.knots().items():
                    self.params[k] = a(np.asarray(v))
            elif hasattr(m, "jax_params"):
                for k, v in m.jax_params().items():
                    self.params[k] = a(v)
            else:  # generic protocol model: sample the affine scalars
                self.params["alpha"] = a(m.tau_mix(0.0))
                self.params["beta"] = a(m.tau_mix(1.0) - m.tau_mix(0.0))
                self.params["tau_solo"] = a(m.tau_solo(0.0))
                self.params["b_s"] = a(m.tau_solo(1.0) - m.tau_solo(0.0))
        if cfg.fleet is not None:
            # heterogeneous fleet (duck-typed: ``n`` and
            # ``server_params(prim)``): the four time surfaces plus the
            # KV-transfer charge become (n,) per-server arrays
            if m is not None:
                raise ValueError("EngineConfig.fleet and iter_model are "
                                 "mutually exclusive")
            if int(cfg.fleet.n) != self.n:
                raise ValueError(
                    f"fleet has {int(cfg.fleet.n)} servers but "
                    f"n_servers={self.n}")
            fp = cfg.fleet.server_params(prim)
            for k_ in ("alpha", "beta", "tau_solo", "b_s", "kv_xfer"):
                self.params[k_] = a(fp[k_])
        self._static = dict(
            n_steps=self.n_steps, n=self.n, B=int(prim.batch_cap),
            gate_kind=self.gate_kind, router_kind=self.router_kind,
            charging=policy.charging, partition=self.partition,
            sarathi=bool(cfg.sarathi_budget),
            unchunked=bool(cfg.vllm_unchunked),
            prefill_only=bool(policy.prefill_only_mixed),
            has_pw=self.has_pw,
            # deadline machinery is left out on the (default) traces
            # where every request has patience == inf
            expiry=bool(np.isfinite(tt.patience[arrived]).any()),
            loop=loop, model_kind=self.model_kind,
            k_events=int(k_events), fastforward=bool(fastforward),
            telemetry=resolve_probe_spec(telemetry))
        self.telemetry = self._static["telemetry"]

    # -- raw (tensor) interface --------------------------------------------
    def _key(self, seed):
        if isinstance(seed, (int, np.integer)):
            return prng_key(int(seed))
        return seed

    @property
    def statics(self) -> dict:
        """The loop's static kwargs -- pass them to the module-level
        :func:`run` facade next to :attr:`params`."""
        return dict(self._static)

    def run_raw(self, seed) -> dict:
        """One replication; returns the raw carry (device tensors)."""
        return run(self.params, self._key(seed), placement="single",
                   **self._static)

    def run_batch_raw(self, seeds: Sequence, *,
                      placement: str = "vmap") -> dict:
        """All replications in one batch; tensors gain a leading
        replication axis.  ``placement`` as in :func:`run`."""
        return run(self.params, [self._key(s) for s in seeds],
                   placement=placement, **self._static)

    # -- EngineMetrics.summary() interface ---------------------------------
    def _summary(self, o: dict) -> dict:
        st = np.asarray(o["st"])
        t_first = np.asarray(o["t_first"], dtype=np.float64)
        t_last = np.asarray(o["t_last"], dtype=np.float64)
        t_arr = self.params["t_arr"].cpu().numpy().astype(np.float64)
        D = self.params["D"].cpu().numpy().astype(np.float64)

        arrivals = int((st != _NOT_ARRIVED).sum())
        completions = int((st == _DONE).sum())
        emitted = np.isfinite(t_first)
        ttft = t_first[emitted] - t_arr[emitted]
        tp_mask = (st == _DONE) & (D > 1)
        tpot = ((t_last[tp_mask] - t_first[tp_mask])
                / np.maximum(D[tp_mask] - 1.0, 1.0))

        def pct(v, q):
            return float(np.percentile(v, q)) if v.size else float("nan")

        # budget diagnostic: an event still pending before the horizon
        # means the step cap cut the replay short
        ap = int(o["aptr"])
        next_arr = (float(t_arr[ap]) if ap < t_arr.shape[0]
                    and st[ap] == _NOT_ARRIVED else np.inf)
        next_t = min(next_arr,
                     float(np.asarray(o["t_next"], dtype=np.float64).min(
                         initial=np.inf)))
        horizon = self.h_eff if self.h_eff > 0 else 1.0
        return {
            "revenue_rate": float(o["rev"]) / horizon,
            "completion_rate": completions / arrivals if arrivals else 0.0,
            "ttft_mean": float(ttft.mean()) if ttft.size else float("nan"),
            "ttft_p95": pct(ttft, 95),
            "ttft_p99": pct(ttft, 99),
            "tpot_mean": float(tpot.mean()) if tpot.size else float("nan"),
            "tpot_p95": pct(tpot, 95),
            "tpot_p99": pct(tpot, 99),
            "completions": completions,
            "arrivals": arrivals,
            "abandons": int(o["abandons"]),
            "t_end": float(o["t"]),
            "budget_exhausted": float(next_t <= self.h_eff),
            "n_iters": float(o["n_iters"]),
            "n_events": float(o["n_events"]),
            "n_steps": float(self.n_steps),
            "n_dropped": float(self.trace.n_dropped),
        }

    def summaries_from_raw(self, raw: dict) -> list:
        """Split a :meth:`run_batch_raw` carry into per-replication
        summary dicts (:meth:`EngineMetrics.summary` keys + engine
        diagnostics)."""
        host = _host(raw)
        reps = host["t"].shape[0]
        return [self._summary({k: v[r] for k, v in host.items()})
                for r in range(reps)]

    # -- telemetry interface ----------------------------------------------
    def telemetry_from_raw(self, raw: dict) -> dict:
        """Host-side probe report (:func:`extract_probes`) from a raw
        carry; batched carries reduce over their leading axes.  Requires
        the engine to have been built with ``telemetry=``."""
        if self.telemetry is None:
            raise ValueError("engine was built without telemetry; pass "
                             "telemetry=ProbeSpec(...) (or True)")
        return extract_probes(_host(raw), self.telemetry,
                              horizon=self.h_eff if self.h_eff > 0 else 1.0,
                              n_servers=self.n)

    def lifecycle_records_from_raw(self, raw: dict,
                                   limit: Optional[int] = None) -> list:
        """Per-request lifecycle records for the Chrome-trace exporter
        from a SINGLE-replication raw carry.  The carry tracks
        arrival/first/last only, so queue wait and prefill render as one
        merged span."""
        o = _host(raw)
        st = o["st"]
        if st.ndim != 1:
            raise ValueError("lifecycle records need a single-replication "
                             "carry; index one replication first")
        t_first = o["t_first"].astype(np.float64)
        t_last = o["t_last"].astype(np.float64)
        t_arr = self.params["t_arr"].cpu().numpy().astype(np.float64)
        cls = self.params["cls"].cpu().numpy()
        names = ("not_arrived", "queued", "prefill", "buffered", "decode",
                 "done", "abandoned")
        records = []
        for rid in np.nonzero(st != _NOT_ARRIVED)[0]:
            records.append({
                "rid": int(rid),
                "cls": self.classes[int(cls[rid])].name,
                "t_arr": float(t_arr[rid]),
                "t_first": float(t_first[rid]),
                "t_last": float(t_last[rid]),
                "state": names[int(st[rid])],
            })
            if limit is not None and len(records) >= limit:
                break
        return records

    def run(self, seed=0) -> dict:
        return self._summary(_host(self.run_raw(seed)))

    def run_batch(self, seeds: Sequence, *, placement: str = "vmap") -> list:
        return self.summaries_from_raw(
            self.run_batch_raw(seeds, placement=placement))
