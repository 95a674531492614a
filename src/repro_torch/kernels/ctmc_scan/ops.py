"""The uniformized CTMC's event loop: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the body of ``repro.core.ctmc_jax.run_uniformized_batch`` (a
``jax.vmap`` over replications of a ``lax.scan`` of one event per step;
not a Pallas kernel).  One call runs a batch of replications to the end
of their step budgets.  Each replication brings its own parameter block,
so cells of different size, pricing scheme or policy share one call:

* ``fparams`` (R, 16 I + 7) in the run's dtype: the per-class vectors of
  :data:`FVEC`, I entries each, then the scalars of :data:`FSCAL`;
* ``iparams`` (R, 8) int64: :data:`IPAR` -- the step budget, the gate,
  router, charging and stepping codes, and the two 32-bit words of the
  replication's generator key (:func:`repro_torch.compat.prng_key`).

The result is the reference's carry, one row per replication.  Both
versions draw their random numbers from Philox4x32-10 keyed by the
replication's key and counted by the step, so on the same inputs they
follow the same path: four uniforms per step, each from 24 bits of one
32-bit word in float32 or from 53 bits of two words in float64.  The
plain version takes every sum in the order the kernel does (a running
sum, left to right), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from ..build import load
from .._checks import check_launch
from ...telemetry.probes import (CTMC_PROBE_KEYS, ProbeSpec,
                                 ctmc_probe_carry, wrap_ctmc_step_probes)

__all__ = ["FSCAL", "FVEC", "IPAR", "MAX_CLASSES", "GATES", "ROUTERS",
           "CHARGINGS", "STEPPINGS", "CVEC", "CSCAL", "ctmc_scan",
           "ctmc_scan_plain", "pack_block", "philox4x32", "uniforms"]

#: per-class parameter vectors of a block, in order (I entries each)
FVEC = ("lam_tot", "theta", "mu_p", "mu_m", "mu_s", "w", "w_pre", "w_dec",
        "x_star", "qp_star", "ratio", "p_s", "pw_m", "pw_s", "qp_cap",
        "qd_cap")
#: scalar parameters of a block, after the vectors
FSCAL = ("n", "M", "cap_m", "cap_s", "Lambda", "horizon", "warmup")
#: int64 parameters of a block
IPAR = ("n_steps", "gate", "router", "charging", "has_pw", "stepping",
        "key0", "key1")
GATES = ("occupancy", "priority", "fcfs")
ROUTERS = ("solo_first", "randomized")
CHARGINGS = ("bundled", "separate")
STEPPINGS = ("events", "ticks")
#: per-class carry vectors and carry scalars, in the kernel's order
CVEC = ("qp", "x", "qdm", "qds", "ym", "ys", "acc_x", "acc_ym", "acc_ys",
        "acc_qp", "acc_qd", "completions", "arrivals", "ab_p", "ab_d")
CSCAL = ("t", "rev", "acc_t", "clip_steps", "n_events")
#: the largest class count the kernel is built for (csrc/ctmc_scan.cu,
#: kMaxClasses); the reference's tests and benchmarks run I <= 3
MAX_CLASSES = 4
_EPS_TARGET = 1e-12  # OccupancyGate's "class is never admitted" threshold
_DTYPES = {torch.float32: 0, torch.float64: 1}
# steps per kernel launch: the carry goes back to device memory between
# launches, and the wrapper stops once no replication is active
_BLOCK_STEPS = 1 << 22
# steps whose uniforms the plain version draws at once
_PLAIN_BLOCK = 512

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


# ----------------------------------------------------------- the generator
def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m for uint32 values held in int64
    tensors; by 16-bit limbs, so no product leaves int64."""
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    mid = ah * ml + al * mh  # < 2**33
    low = al * ml + ((mid & 0xFFFF) << 16)  # < 2**33
    lo = low & _MASK32
    hi = (ah * mh + (mid >> 16) + (low >> 32)) & _MASK32
    return hi, lo


def philox4x32(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11): ``ctr`` (..., 4) and ``key``
    (..., 2) int64 tensors of 32-bit words -> (..., 4) words."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), -1)


def uniforms(keys, step0: int, n: int, dtype):
    """The four uniforms in [0, 1) of steps ``step0 .. step0 + n - 1`` of
    each replication: (R, n, 4) in ``dtype``.

    Step s's counter is ``(s mod 2**32, s >> 32, j, 0)``.  float32 takes
    call j = 0 and 24 bits of each word; float64 takes calls j = 0 and 1
    and 53 bits of each pair of words (27 from the first, 26 from the
    second), as numpy's doubles do.  Every value converts exactly."""
    R = keys.shape[0]
    s = torch.arange(step0, step0 + n, dtype=torch.int64, device=keys.device)
    key = keys[:, None, :].expand(R, n, 2)

    def call(j):
        ctr = torch.stack((s & _MASK32, s >> 32, torch.full_like(s, j),
                           torch.zeros_like(s)), -1)
        return philox4x32(ctr[None].expand(R, n, 4), key)

    a = call(0)
    if dtype == torch.float32:
        return (a >> 8).to(torch.float32) * 2.0 ** -24
    b = call(1)
    return ((a >> 5) * 67108864 + (b >> 6)).to(torch.float64) * 2.0 ** -53


# ------------------------------------------------------------- the block
def pack_block(params: dict, statics: dict, keys) -> tuple:
    """One call's parameter block for R replications of one instance.

    ``params`` holds the reference's parameter names (per-class vectors of
    shape (I,) and scalars, tensors of the run's dtype); ``statics`` the
    step budget and the kinds (``n_steps``, ``gate_kind``,
    ``router_kind``, ``charging``, ``has_pw``, ``stepping``); ``keys``
    (R, 2) the generator keys.  Returns ``(fparams, iparams)`` on
    ``params``' device; blocks of one dtype and class count concatenate
    along the rows into one call."""
    R = keys.shape[0]
    lam = params["lam_tot"]
    row = torch.cat([params[k].reshape(-1) for k in FVEC]
                    + [params[k].reshape(1) for k in FSCAL])
    codes = [int(statics["n_steps"]), GATES.index(statics["gate_kind"]),
             ROUTERS.index(statics["router_kind"]),
             CHARGINGS.index(statics["charging"]), int(statics["has_pw"]),
             STEPPINGS.index(statics["stepping"])]
    ip = torch.cat([torch.tensor(codes, dtype=torch.int64).expand(R, 6),
                    keys.to(torch.int64).cpu()], 1)
    return (row.expand(R, -1).contiguous(),
            ip.to(lam.device).contiguous())


def _unpack_params(fparams, iparams, I: int) -> dict:
    P = {k: fparams[:, j * I:(j + 1) * I] for j, k in enumerate(FVEC)}
    base = len(FVEC) * I
    P.update({k: fparams[:, base + j] for j, k in enumerate(FSCAL)})
    P["n_steps"] = iparams[:, 0]
    P["keys"] = iparams[:, 6:8]
    return P


def _unpack_carry(carry, tlm, I: int) -> dict:
    out = {k: carry[:, j * I:(j + 1) * I] for j, k in enumerate(CVEC)}
    base = len(CVEC) * I
    out.update({k: carry[:, base + j] for j, k in enumerate(CSCAL)})
    if tlm is not None:
        out["tlm_q"] = tlm[:, :, :I]
        for j, k in enumerate(CTMC_PROBE_KEYS[1:]):
            out[k] = tlm[:, :, I + j]
    return out


# ------------------------------------------------------- the plain version
def _cumsum(w):
    """Running sum along the last axis, left to right (the kernel's order;
    ``torch.cumsum`` sums in another order on the card and in double on
    the CPU)."""
    c = w.clone()
    cols = c.unbind(1)
    for k in range(1, len(cols)):
        cols[k].add_(cols[k - 1])
    return c


def _categorical(u, weights):
    """Index ~ weights/sum(weights) from one uniform draw per row.

    Right-side search on the running sum, so a zero-weight entry is never
    drawn; an all-zero row gives the last index (callers mask that case
    with their own validity flag)."""
    c = _cumsum(weights)
    i = torch.searchsorted(c, (u * c[:, -1])[:, None], right=True)[:, 0]
    return torch.clamp(i, max=weights.shape[1] - 1)


# the plain carry keeps the state, the accumulators and the per-class
# counters stacked, so one step updates each with a few tensor ops
_STATE = ("qp", "x", "qdm", "qds", "ym", "ys")
_ACC = ("acc_x", "acc_ym", "acc_ys", "acc_qp", "acc_qd")
_COUNT = ("completions", "arrivals", "ab_p", "ab_d")


def _named(carry: dict) -> dict:
    """The reference's carry names, as views of the stacks."""
    out = dict(carry)
    for key, names in (("_S", _STATE), ("_A", _ACC), ("_C", _COUNT)):
        out.update(zip(names, carry[key].unbind(1)))
    return out


def _build_step(P: dict, U, gate_kind: str, router_kind: str, charging: str,
                has_pw: bool, stepping: str):
    """The batched step: one Lambda-clock tick (``"ticks"``) or one real
    transition with self-loops skipped (``"events"``) of every
    replication.  ``U(idx)`` gives the step's uniforms, (R, 4).

    Each element sees the reference's arithmetic: the state's updates add
    one-hot multiples of the event's increments (integer counts, exact),
    the accumulators add ``eff`` times the pre-event state.  A step with
    ``t >= horizon`` or ``idx >= n_steps`` is inactive, and an inactive
    step changes nothing: the event, the accumulated time, the admission
    and the clip count are all zero, and every update adds zero."""
    R, I = P["lam_tot"].shape
    dtype, dev = P["lam_tot"].dtype, P["lam_tot"].device
    ar = torch.arange(R, device=dev)
    arI = torch.arange(I, device=dev)
    ar6 = torch.arange(6, device=dev)
    horizon, warmup = P["horizon"], P["warmup"]
    ones = torch.ones((R, I), dtype=dtype, device=dev)
    # 0-d constants: a Python number in an operation costs a host-side
    # tensor of its own at every step
    one = torch.ones((), dtype=dtype, device=dev)
    inf = torch.full((), math.inf, dtype=dtype, device=dev)
    # rate coefficients of the stacked [1, x, ym, ys, qp, qd]
    coef = torch.stack([P["lam_tot"], P["mu_p"], P["mu_m"], P["mu_s"],
                        P["theta"], P["theta"]], 1)
    theta_pos = P["theta"] > 0
    # the occupancy gate's divisor and mask do not change
    xs_mask = P["x_star"] > _EPS_TARGET
    xs_div = torch.clamp_min(P["x_star"], 1e-30)
    n_x_star = P["n"][:, None] * P["x_star"]
    n_qp_star = P["n"][:, None] * P["qp_star"]

    def onehot(i):
        return (arI == i[:, None]).to(dtype)

    def at(v, i):
        return v.gather(1, i[:, None])[:, 0]

    def step(carry, idx):
        u = U(idx)
        S = carry["_S"]
        qp, x, qdm, qds, ym, ys = S.unbind(1)
        t = carry["t"]
        qd = qdm + qds

        active = (t < horizon) & (idx < P["n_steps"])

        # -- holding time + which event fires ------------------------------
        if stepping == "ticks":
            # Lambda-clock: abandonment rates clipped at the caps so the
            # static bound Lambda >= R(s) holds; excess mass self-loops
            occ = torch.stack([ones, x, ym, ys,
                               torch.minimum(qp, P["qp_cap"]),
                               torch.minimum(qd, P["qd_cap"])], 1)
            c = _cumsum((coef * occ).flatten(1))
            lam = P["Lambda"]
            dt = -torch.log1p(-u[:, 0]) / lam
            t_new = torch.minimum(t + dt, horizon)
            idx_ev = torch.searchsorted(c, (u[:, 1] * lam)[:, None],
                                        right=True)[:, 0]
            live = idx_ev < 6 * I  # ticks past R(s) are self-loops
        else:
            # embedded jumps: exact (unclipped) rates, Exp(R(s)) holding
            occ = torch.stack([ones, x, ym, ys, qp, qd], 1)
            c = _cumsum((coef * occ).flatten(1))
            total = c[:, -1]
            dt = torch.where(total > 0, -torch.log1p(-u[:, 0])
                             / torch.clamp_min(total, 1e-30), horizon)
            t_new = torch.minimum(t + dt, horizon)
            idx_ev = torch.searchsorted(c, (u[:, 1] * total)[:, None],
                                        right=True)[:, 0]
            live = total > 0
        # time-average accumulation over [t, t_new) with the PRE-event
        # state (the event, if any, happens at t_new); events at exactly
        # the horizon are never applied (matching the Python loop's break)
        eff = torch.clamp_min(t_new - torch.maximum(t, warmup), 0.0) * active
        ev = active & (t_new < horizon) & live
        idx_c = torch.clamp_max(idx_ev, 6 * I - 1)
        i = idx_c % I
        oh_i = onehot(i)
        # the event's category, one-hot: arrival, prefill completion,
        # mixed / solo decode completion, prefill / decode abandonment
        E = ((idx_c // I)[:, None] == ar6) & ev[:, None]
        is_arr, is_pc, is_md, is_sd, is_ap, is_ad = E.unbind(1)
        Ef = E.to(dtype)
        f_arr, f_pc, f_md, f_sd, f_ap, f_ad = Ef.unbind(1)

        free_s = P["cap_s"] - ys.sum(1)
        free_m = P["cap_m"] - ym.sum(1)

        # -- route the decode of a completed class-i prefill ---------------
        if router_kind == "randomized":
            go_solo = u[:, 2] <= at(P["p_s"], i)
            s_ok, m_ok = free_s >= one, free_m >= one
            route = torch.stack([is_pc & go_solo & s_ok,
                                 is_pc & go_solo & ~s_ok,
                                 is_pc & ~go_solo & m_ok,
                                 is_pc & ~go_solo & ~m_ok], 1)
        else:  # solo_first (single logical buffer kept in the solo half)
            s_ok, m_ok = free_s >= one, free_m >= one
            no_s = is_pc & ~s_ok
            route = torch.stack([is_pc & s_ok, no_s & ~m_ok, no_s & m_ok,
                                 torch.zeros_like(is_pc)], 1)
        route_ys, route_qds, route_ym, route_qdm = route.to(dtype).unbind(1)

        # -- pull from the buffer into the slot a decode completion freed --
        pull = is_md | is_sd
        if router_kind == "randomized":
            qpool = torch.where(is_sd[:, None], qds, qdm)
            mask = (qpool >= one).to(dtype)
            if has_pw:
                wsel = torch.where(is_sd[:, None], P["pw_s"], P["pw_m"])
                wsel = wsel * mask
                probs = torch.where((wsel.sum(1) > 0)[:, None], wsel,
                                    qpool * mask)
            else:
                probs = qpool * mask
            j = _categorical(u[:, 2], probs)
            pull_ok = pull & (mask.sum(1) >= one)
            from_ds = pull_ok & is_sd
            from_dm = pull_ok & is_md
        else:
            qtot = qds + qdm
            j = _categorical(u[:, 2], qtot)
            pull_ok = pull & (qtot.sum(1) >= one)
            take_ds = at(qds, j) >= one
            from_ds = pull_ok & take_ds
            from_dm = pull_ok & ~take_ds

        # -- decode abandonment: which buffer half loses the job -----------
        qds_i, qdm_i = at(qds, i), at(qdm, i)
        denom = torch.clamp_min(qds_i + qdm_i, 1.0)
        ab_take_s = (qds_i >= one) & ((qdm_i < one)
                                      | (u[:, 2] < qds_i / denom))

        # -- stage 1: apply the event --------------------------------------
        # class i: [qp, x, qdm, qds, ym, ys] += d_i; class j (the pull):
        # += d_j -- counts, exact in any order
        z = torch.zeros_like(f_arr)
        fl = torch.stack([is_ad & ~ab_take_s, is_ad & ab_take_s,
                          pull_ok & is_md, pull_ok & is_sd, from_dm,
                          from_ds], 1).to(dtype)
        ab_dm, ab_ds, to_ym, to_ys, fr_dm, fr_ds = fl.unbind(1)
        d_i = torch.stack([f_arr - f_ap, z - f_pc, route_qdm - ab_dm,
                           route_qds - ab_ds, route_ym - f_md,
                           route_ys - f_sd], 1)
        d_j = torch.stack([z, z, z - fr_dm, z - fr_ds, to_ym, to_ys], 1)
        S1 = (S + oh_i[:, None, :] * d_i[:, :, None]
              + onehot(j)[:, None, :] * d_j[:, :, None])
        qp1, x1 = S1[:, 0], S1[:, 1]

        # -- stage 2: prefill admission (at most one needed per event) -----
        adm_ev = is_arr | is_pc
        free_p = P["M"] - x1.sum(1)
        if gate_kind == "occupancy":
            mask = (qp1 >= one) & xs_mask
            xi = (x1 + one - n_x_star) / xs_div
            keyv = torch.where(mask, xi, inf)
            tie = mask & (keyv == torch.amin(keyv, 1, keepdim=True))
            delta = qp1 - n_qp_star
            cand = torch.argmax(torch.where(tie, delta, -inf), 1)
            can_admit = mask.any(1)
        elif gate_kind == "priority":
            mask = qp1 >= one
            cand = torch.argmax(torch.where(mask, P["ratio"], -inf), 1)
            can_admit = mask.any(1)
        else:  # fcfs: head-of-line class ~ queue lengths (exchangeable)
            cand = _categorical(u[:, 3], qp1)
            can_admit = qp1.sum(1) >= one
        admit = (adm_ev & can_admit & (free_p >= one)).to(dtype)
        d_c = torch.stack([z - admit, admit, z, z, z, z], 1)
        S2 = S1 + onehot(cand)[:, None, :] * d_c[:, :, None]

        # -- revenue -------------------------------------------------------
        if charging == "separate":
            rev_inc = (at(P["w_pre"], i) * f_pc
                       + at(P["w_dec"], i) * (f_md + f_sd))
        else:
            rev_inc = at(P["w"], i) * (f_md + f_sd)
        rev_inc = rev_inc * (t_new > warmup).to(dtype)

        if stepping == "ticks":
            clipped = active & (((theta_pos & (qp > P["qp_cap"])).any(1))
                                | ((theta_pos & (qd > P["qd_cap"])).any(1)))
        else:  # exact rates; nothing to clip
            clipped = torch.zeros_like(active)

        A = carry["_A"] + eff[:, None, None] * torch.stack(
            [x, ym, ys, qp, qd], 1)
        C = carry["_C"] + oh_i[:, None, :] * torch.stack(
            [f_md + f_sd, f_arr, f_ap, f_ad], 1)[:, :, None]
        new = {
            "_S": S2, "_A": A, "_C": C,
            "t": torch.where(active, t_new, t),
            "rev": carry["rev"] + rev_inc,
            "acc_t": carry["acc_t"] + eff,
            "clip_steps": carry["clip_steps"] + clipped.to(dtype),
            "n_events": carry["n_events"] + ev.to(dtype),
        }
        return new, None

    return step


def _run_group(P: dict, I: int, statics: tuple, spec: Optional[ProbeSpec]
               ) -> dict:
    """The plain loop over the replications of one (gate, router,
    charging, has_pw, stepping) kind, until every one is inactive."""
    gate, router, charging, has_pw, stepping = statics
    R = P["lam_tot"].shape[0]
    dtype, dev = P["lam_tot"].dtype, P["lam_tot"].device

    def z(*shape):
        return torch.zeros((R,) + shape, dtype=dtype, device=dev)

    carry = {"_S": z(len(_STATE), I), "_A": z(len(_ACC), I),
             "_C": z(len(_COUNT), I)}
    carry.update({k: z() for k in CSCAL})
    block = {"s0": 0, "u": None}

    def U(idx):
        if block["u"] is None or not 0 <= idx - block["s0"] < _PLAIN_BLOCK:
            block["s0"] = idx
            block["u"] = uniforms(P["keys"], idx, _PLAIN_BLOCK, dtype)
        return block["u"][:, idx - block["s0"]]

    step = _build_step(P, U, GATES[gate], ROUTERS[router],
                       CHARGINGS[charging], bool(has_pw), STEPPINGS[stepping])
    if spec is not None:
        # the probes read the carry by the reference's names
        carry = _named(carry)
        carry.update(ctmc_probe_carry(spec, I=I, dtype=dtype, batch=(R,),
                                      device=dev))
        bare = step

        def named(c, idx):
            out, aux = bare(c, idx)
            return _named(out), aux

        step = wrap_ctmc_step_probes(named, spec, P["horizon"])
    n_max = int(P["n_steps"].max())
    for s0 in range(0, n_max, _PLAIN_BLOCK):
        # every later step of an inactive replication changes nothing,
        # so the loop ends once none is active (one read per block)
        if not bool(((carry["t"] < P["horizon"])
                     & (s0 < P["n_steps"])).any()):
            break
        for idx in range(s0, min(s0 + _PLAIN_BLOCK, n_max)):
            carry, _ = step(carry, idx)
    return {k: v for k, v in _named(carry).items() if not k.startswith("_")}


def _check(fparams, iparams, n_classes: int, n_bins: int) -> int:
    if fparams.dtype not in _DTYPES:
        raise TypeError(f"ctmc_scan: dtype {fparams.dtype} not supported "
                        f"(float32 or float64)")
    if iparams.dtype != torch.int64 or iparams.device != fparams.device:
        raise ValueError("ctmc_scan: iparams must be int64 on fparams' "
                         "device")
    R = fparams.shape[0]
    nf = len(FVEC) * n_classes + len(FSCAL)
    if fparams.shape != (R, nf) or iparams.shape != (R, len(IPAR)) or R < 1:
        raise ValueError(f"ctmc_scan: need fparams (R, {nf}) and iparams "
                         f"(R, {len(IPAR)}) for I={n_classes}, R >= 1; got "
                         f"{tuple(fparams.shape)} and {tuple(iparams.shape)}")
    if not (fparams.is_contiguous() and iparams.is_contiguous()):
        raise ValueError("ctmc_scan: inputs must be contiguous")
    if n_bins < 0:
        raise ValueError(f"ctmc_scan: n_bins must be >= 0, got {n_bins}")
    return R


def ctmc_scan_plain(fparams, iparams, *, n_classes: int,
                    n_bins: int = 0) -> Dict[str, torch.Tensor]:
    """The plain version: the batched step in PyTorch, looped on the host.

    Replications are grouped by their kinds (the reference compiles one
    program per kind); ``n_bins > 0`` threads the CTMC probes
    (``tlm_*``) through the step.  Returns the carry, one row per
    replication."""
    R = _check(fparams, iparams, n_classes, n_bins)
    I = n_classes
    P = _unpack_params(fparams, iparams, I)
    spec = ProbeSpec(n_bins=n_bins) if n_bins else None
    kinds = iparams[:, 1:6].cpu()
    groups: Dict[tuple, list] = {}
    for r in range(R):
        groups.setdefault(tuple(int(v) for v in kinds[r]), []).append(r)
    out: Dict[str, torch.Tensor] = {}
    for statics, rows in groups.items():
        sel = torch.tensor(rows, device=fparams.device)
        # inference mode skips autograd's dispatch: the loop is host-bound
        with torch.inference_mode():
            got = _run_group({k: v[sel] for k, v in P.items()}, I, statics,
                             spec)
        for k, v in got.items():
            if k not in out:
                out[k] = torch.empty((R,) + v.shape[1:], dtype=v.dtype,
                                     device=v.device)
            out[k][sel] = v
    return out


# ---------------------------------------------------------------- the kernel
@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("ctmc_scan").ctmc_scan_launch
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ctmc_scan(fparams, iparams, *, n_classes: int,
              n_bins: int = 0) -> Dict[str, torch.Tensor]:
    """Run every replication of the block to the end of its step budget.

    CUDA tensors launch the kernel (``csrc/ctmc_scan.cu``): a warp per
    replication, the carry in registers, in launches of up to
    ``_BLOCK_STEPS`` steps; between launches the carry waits in device
    memory, and the wrapper reads one count (the replications still
    active) per launch, never per step.  CPU tensors run
    :func:`ctmc_scan_plain`.  Launches count in ``ctmc_scan.launches``.
    Raises for a class count above :data:`MAX_CLASSES` on the card."""
    R = _check(fparams, iparams, n_classes, n_bins)
    if fparams.device.type == "cpu":
        return ctmc_scan_plain(fparams, iparams, n_classes=n_classes,
                               n_bins=n_bins)
    if fparams.device.type != "cuda":
        raise ValueError(f"ctmc_scan: unsupported device {fparams.device}")
    I = n_classes
    if not 1 <= I <= MAX_CLASSES:
        raise ValueError(f"ctmc_scan: the kernel is built for 1 to "
                         f"{MAX_CLASSES} classes (MAX_CLASSES), got I={I}")
    dev = fparams.device
    carry = torch.zeros((R, len(CVEC) * I + len(CSCAL)), dtype=fparams.dtype,
                        device=dev)
    tlm = (torch.zeros((R, n_bins, I + len(CTMC_PROBE_KEYS) - 1),
                       dtype=fparams.dtype, device=dev) if n_bins else None)
    active = torch.zeros(1, dtype=torch.int32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_max = int(iparams[:, 0].max())
    for s0 in range(0, n_max, _BLOCK_STEPS):
        active.zero_()
        err = _launcher()(
            index, _DTYPES[fparams.dtype], I, n_bins, fparams.data_ptr(),
            iparams.data_ptr(), carry.data_ptr(),
            None if tlm is None else tlm.data_ptr(), active.data_ptr(), R,
            s0, min(s0 + _BLOCK_STEPS, n_max), stream)
        check_launch("ctmc_scan", err)
        ctmc_scan.launches += 1
        if int(active.item()) == 0:
            break
    return _unpack_carry(carry, tlm, I)


ctmc_scan.launches = 0
