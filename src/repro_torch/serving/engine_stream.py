"""Streamed trace replay over a compacted working-set window.

:class:`~repro_torch.serving.engine_jax.ClusterEngineJAX` replays one
host-padded ``(R,)`` trace: every per-request array is sized by the
*whole* trace.  :class:`StreamingEngineJAX` removes that ceiling: it
drives the *same* step over a fixed working set of ``window`` rows,
consuming the trace as fixed-shape chunks
(:func:`repro_torch.data.traces.chunk_trace` output, or a
:class:`repro_torch.workloads.batch.ScenarioStream` that samples
arrivals on the device as it goes) and retiring finished requests
between chunks.  The module keeps the reference's name
(``repro.serving.engine_stream``) and semantics.

**Segments and the frontier.**  The replay alternates two phases.
:func:`_compact_splice` retires rows whose future is decided
(``DONE``/``ABANDONED``: their TTFT/TPOT/completion contributions fold
into scalar accumulators), compacts the survivors to the front of the
window with a stable order-preserving permutation (new row ids stay in
arrival order, which keeps per-class FCFS an ``argmin`` and the queue
windows valid), remaps every rid-valued structure (decode slots, active
prefills, the FCFS ring) through the permutation, splices the next
chunk's rows after the survivors, and rebuilds the per-class FCFS
tables.  The segment loop (``engine_jax.run(..., segment=...)``) then
runs the engine step, each step guarded by the reference's loop
condition: an event pending at or before the horizon, *strictly before
the frontier* -- the first arrival of the next, not-yet-spliced chunk --
and within the budget.  On the card the segment loop replays the
engine's CUDA graph of guarded steps; the splice runs eagerly.

**What can stream.**  The deterministic global-buffer routers
(``solo_first`` / ``local_fcfs``), any gate family, ``k_events == 1``,
no deadlines.  The working set must hold every *unfinished* request at
any instant plus one chunk of future arrivals; a splice that would
overflow the window raises (never silently drops load).  Percentile
metrics are not computable from streamed scalars and are reported as
``NaN``; means, completion counts and revenue are exact.

Horizon semantics are *drain*: the replay runs to ``horizon``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import prng_key
from repro_torch.core.policies import PolicySpec
from repro_torch.core.types import WorkloadClass
from repro_torch.data.traces import (TraceTensors, TraceValidationError,
                                     chunk_trace, tensorize_trace)
from repro_torch.telemetry.probes import extract_probes, hist_edges

from .engine_jax import (ClusterEngineJAX, _DECODE, _DONE, _NOT_ARRIVED,
                         _QUEUED, _init_carry, iteration_budget,
                         run as run_engine_facade)
from .engine_sim import EngineConfig

__all__ = ["StreamingEngineJAX", "TraceChunkSource"]

# the splice's per-segment scalars, read back in one copy
_SEG = ("ret", "done", "ttft_sum", "ttft_n", "tpot_sum", "tpot_n",
        "n_live", "n_new", "overflow")


class TraceChunkSource:
    """``next_chunk()`` over pre-chunked :class:`TraceTensors`.

    Accepts either a sequence of equal-shape chunks (``chunk_trace``
    output) or a raw request list plus ``chunk_size`` (chunked here).
    Verifies all chunks share one padded shape.
    """

    def __init__(self, chunks, chunk_size: Optional[int] = None):
        if chunk_size is not None:
            chunks = chunk_trace(chunks, chunk_size)
        self._chunks = list(chunks)
        shapes = {c.R for c in self._chunks}
        if len(shapes) > 1:
            raise TraceValidationError(
                f"chunks must share one padded shape, got {sorted(shapes)}")
        self._it = iter(self._chunks)

    def next_chunk(self) -> Optional[TraceTensors]:
        return next(self._it, None)


def _compact_splice(carry, tbl, ch, h_eff, tlm_edges=None):
    """Retire finished rows, compact survivors, splice the next chunk.

    A function of one replication's (unbatched) carry, the per-request
    tables and one chunk; returns ``(carry', tbl', seg)`` where ``seg``
    (a tensor in the order of ``_SEG``) holds this splice's retired-row
    metric contributions and diagnostics, accumulated on the host in
    float64.  With telemetry on, ``tlm_edges`` folds the retired rows'
    TTFT/E2E latencies into ``tlm_ttft``/``tlm_e2e`` before their time
    marks are evicted (0/1 adds: exact)."""
    c = dict(carry)
    tbl = dict(tbl)
    t_arr = tbl["t_arr"]
    Rw = t_arr.shape[0]
    dev, f32 = t_arr.device, t_arr.dtype
    inf = math.inf
    iota = torch.arange(Rw, device=dev)

    st = c["st"]
    real = t_arr < inf
    keep = (((st >= _QUEUED) & (st <= _DECODE))
            | ((st == _NOT_ARRIVED) & real))
    ret = real & ~keep  # DONE / ABANDONED: metrics are final

    # retired-row metric contributions (before any reshuffle)
    t_first, t_last = c["t_first"], c["t_last"]
    D = tbl["D"]
    emitted = ret & torch.isfinite(t_first)
    done = ret & (st == _DONE)
    tpm = done & (D > 1.0)
    seg = {
        "ret": ret.to(f32).sum(),
        "done": done.to(f32).sum(),
        "ttft_sum": torch.where(emitted, t_first - t_arr, 0.0).sum(),
        "ttft_n": emitted.to(f32).sum(),
        "tpot_sum": torch.where(
            tpm, (t_last - t_first) / torch.clamp_min(D - 1.0, 1.0),
            0.0).sum(),
        "tpot_n": tpm.to(f32).sum(),
    }
    if tlm_edges is not None:
        hb = torch.searchsorted(tlm_edges, t_first - t_arr)
        c["tlm_ttft"] = c["tlm_ttft"].scatter_add(0, hb, emitted.to(f32))
        hb = torch.searchsorted(tlm_edges, t_last - t_arr)
        c["tlm_e2e"] = c["tlm_e2e"].scatter_add(0, hb, done.to(f32))

    # stable keep-first permutation from unique integer keys: new rids
    # stay in arrival order
    order = torch.argsort(torch.where(keep, iota, Rw + iota))
    n_live = keep.sum()
    newpos = torch.zeros_like(iota).scatter(0, order, iota)
    newpos = torch.where(keep, newpos, -1)

    def remap(r):
        return torch.where(r >= 0, newpos[torch.clamp(r, 0, Rw - 1)], -1)

    c["slot_rid"] = remap(c["slot_rid"])
    c["pf_rid"] = remap(c["pf_rid"])
    # FCFS ring: shift the live window to the front, rids remapped
    RL = c["buf"].shape[0]
    rl = torch.arange(RL, device=dev)
    rwin = c["buf"][torch.clamp(c["buf_hd"] + rl, 0, RL - 1)]
    in_ring = rl < (c["buf_tl"] - c["buf_hd"])
    c["buf"] = torch.where(in_ring, remap(rwin), -1)
    c["buf_tl"] = c["buf_tl"] - c["buf_hd"]
    c["buf_hd"] = torch.zeros_like(c["buf_hd"])

    # arrivals cursor: the kept rows whose arrival was consumed form a
    # prefix
    c["aptr"] = (keep & (st != _NOT_ARRIVED)).sum()

    # splice the chunk's in-horizon rows after the survivors
    C = ch["t"].shape[0]
    chv = ch["valid"] & (ch["t"] <= h_eff)
    n_new = chv.sum()
    seg["n_live"] = n_live
    seg["n_new"] = n_new
    seg["overflow"] = (n_live + n_new) > Rw
    pos = torch.arange(C, device=dev) + n_live

    def splice(old, newv, pad):
        p = torch.where(iota < n_live, old[order], pad)
        # writes past the window are dropped (the reference's
        # mode="drop"): they land in a tail that is cut off
        ext = torch.cat([p, torch.full((C,), pad, dtype=p.dtype,
                                       device=dev)])
        ext[pos] = torch.where(chv, newv.to(p.dtype), pad)
        return ext[:Rw]

    tbl["t_arr"] = splice(t_arr, ch["t"], inf)
    tbl["cls"] = splice(tbl["cls"], ch["cls"], 0)
    tbl["P"] = splice(tbl["P"], ch["P"], 1.0)
    tbl["D"] = splice(tbl["D"], ch["D"], 1.0)
    c["st"] = splice(st, torch.zeros(C, dtype=st.dtype, device=dev), 0)
    c["t_first"] = splice(t_first, torch.full((C,), inf, dtype=f32,
                                              device=dev), inf)
    c["t_last"] = splice(t_last, torch.full((C,), -inf, dtype=f32,
                                            device=dev), -inf)
    if "tout" in c:  # non-fastforward carry keeps the (R,) token array
        c["tout"] = splice(c["tout"], torch.zeros(C, dtype=f32, device=dev),
                           0.0)

    # per-class FCFS tables over queued + future rows (in new-rid order
    # queued rows precede future ones, so the windows [0, #queued_i)
    # are exactly the live queues)
    st2, t2, cls2 = c["st"], tbl["t_arr"], tbl["cls"]
    qf = (st2 == _QUEUED) | ((st2 == _NOT_ARRIVED) & (t2 < inf))
    I = c["qarr"].shape[0]
    ci = torch.arange(I, device=dev)[:, None]
    m = qf[None, :] & (cls2[None, :] == ci)
    r = torch.argsort(torch.where(m, iota, Rw + iota), dim=1)
    tbl["class_rids"] = torch.where(iota < m.sum(1, keepdim=True), r, Rw)
    c["qhead"] = torch.zeros_like(c["qhead"])
    c["qarr"] = ((st2 == _QUEUED)[None, :] & (cls2[None, :] == ci)).sum(1)

    tbl["A"] = (t2 < inf).to(f32).sum()
    ta = torch.where(c["aptr"].to(f32) < tbl["A"],
                     t2[torch.clamp(c["aptr"], 0, Rw - 1)], inf)
    c["alive"] = torch.minimum(ta, c["t_next"].min()) <= h_eff
    seg = torch.stack([seg[k].to(torch.float64) for k in _SEG])
    return c, tbl, seg


class StreamingEngineJAX:
    """Streamed (chunk-fed) twin of :class:`ClusterEngineJAX`.

    Same classes/policy/config inputs; the trace arrives through
    :meth:`run_stream` as a chunk source instead of being fixed at
    construction.  ``window`` is the working-set size (must exceed the
    workload's peak unfinished-request backlog plus one chunk);
    ``dtype`` and ``device`` as in :class:`ClusterEngineJAX`.
    """

    def __init__(self, classes: Sequence[WorkloadClass], policy: PolicySpec,
                 cfg: EngineConfig, horizon: float, *, window: int = 8192,
                 fastforward: bool = True, telemetry=None,
                 dtype=torch.float32, device=None):
        # an empty window-shaped trace gives the full policy/params
        # lowering (and its validations) without duplicating it here
        base = ClusterEngineJAX(classes, policy, cfg,
                                tensorize_trace([], pad_to=int(window)),
                                horizon, drain=True,
                                fastforward=fastforward,
                                telemetry=telemetry, dtype=dtype,
                                device=device)
        if base.router_kind not in ("solo_first", "local_fcfs"):
            raise ValueError(
                "StreamingEngineJAX needs a deterministic global-buffer "
                f"router (solo_first/local_fcfs), got {base.router_kind!r}")
        self._base = base
        self.window = int(window)
        self.h_eff = base.h_eff
        self.classes = base.classes
        self.I = base.I
        self.cfg = cfg
        self.device = base.device
        self._statics = {k: v for k, v in base._static.items()
                         if k not in ("n_steps", "loop")}
        self.telemetry = self._statics["telemetry"]
        self._tlm_edges = (
            torch.as_tensor(hist_edges(self.telemetry), dtype=dtype,
                            device=self.device)
            if self.telemetry is not None else None)

    @torch.inference_mode()
    def run_stream(self, source, seed=0,
                   max_steps: Optional[int] = None) -> dict:
        """Replay one stream; returns a summary dict (engine keys plus
        ``requests``/``n_segments``/``window_peak`` diagnostics)."""
        src = (source if hasattr(source, "next_chunk")
               else TraceChunkSource(source))
        base = self._base
        Rw = self.window
        dev = self.device
        dt = base.params["t_arr"].dtype
        st_ = self._statics
        B = st_["B"]
        carry = _init_carry(Rw, base.n, B, self.I, dt, st_["router_kind"],
                            st_["has_pw"], st_["expiry"], st_["k_events"],
                            st_["fastforward"], st_["telemetry"], nr=1,
                            device=dev)
        carry = {k: v[0] for k, v in carry.items()}
        # the per-segment push count is bounded by the working set, not
        # the whole trace: give the ring two windows of slack
        carry["buf"] = torch.full((2 * Rw + B + 1,), -1, dtype=torch.int64,
                                  device=dev)
        tbl = {
            "t_arr": torch.full((Rw,), math.inf, dtype=dt, device=dev),
            "cls": torch.zeros(Rw, dtype=torch.int64, device=dev),
            "P": torch.ones(Rw, dtype=dt, device=dev),
            "D": torch.ones(Rw, dtype=dt, device=dev),
            "class_rids": torch.full((self.I, Rw), Rw, dtype=torch.int64,
                                     device=dev),
            "A": torch.zeros((), dtype=dt, device=dev),
        }
        acc = {k: 0.0 for k in _SEG[:6]}
        key = prng_key(int(seed)) if isinstance(seed, (int, np.integer)) \
            else seed
        h_eff = torch.tensor(self.h_eff, dtype=dt, device=dev)
        i = torch.zeros((), dtype=torch.int64, device=dev)
        budget = 0
        requests = 0
        n_segments = 0
        window_peak = 0
        occupancy = []  # kept rows right after each splice: backlog trace
        t_seam = -np.inf
        C0 = None
        pending = src.next_chunk()
        while pending is not None:
            ch = pending
            if C0 is None:
                C0 = ch.R
            elif ch.R != C0:
                raise TraceValidationError(
                    f"chunk shape changed mid-stream: {ch.R} != {C0}")
            if ch.n_real:
                t_real = ch.t[ch.valid]
                if t_real[0] < t_seam:
                    raise TraceValidationError(
                        f"stream chunks out of order: chunk starts at "
                        f"t={t_real[0]} before the previous chunk's last "
                        f"arrival t={t_seam}")
                t_seam = float(t_real[-1])
                if np.isfinite(ch.patience[ch.valid]).any():
                    raise ValueError(
                        "StreamingEngineJAX does not support deadlines "
                        "(finite patience) yet; use ClusterEngineJAX")
                if int(ch.cls[ch.valid].max(initial=0)) >= self.I:
                    raise ValueError("chunk references an unknown class")
                arrs = {
                    "t": torch.as_tensor(ch.t, dtype=dt, device=dev),
                    "cls": torch.as_tensor(ch.cls.astype(np.int64),
                                           device=dev),
                    "P": torch.as_tensor(ch.P, dtype=dt, device=dev),
                    "D": torch.as_tensor(ch.D, dtype=dt, device=dev),
                    "valid": torch.as_tensor(ch.valid, device=dev),
                }
                budget += iteration_budget(ch, self.cfg, self.h_eff)
                carry, tbl, seg = _compact_splice(carry, tbl, arrs, h_eff,
                                                  self._tlm_edges)
                seg = dict(zip(_SEG, seg.cpu().tolist()))
                if seg["overflow"]:
                    tail = occupancy[-5:]
                    trace = (", ".join(
                        f"seg{n_segments - len(tail) + j}={v}"
                        for j, v in enumerate(tail))
                        if tail else "none (overflow on first splice)")
                    raise RuntimeError(
                        f"working-set overflow at t~{t_seam:.0f} (segment "
                        f"{n_segments}): {int(seg['n_live'])} live rows + "
                        f"{int(seg['n_new'])} new > window={Rw}; raise "
                        "`window` (peak unfinished backlog exceeded); "
                        f"occupancy after recent splices: {trace}")
                occupancy.append(int(seg["n_live"]) + int(seg["n_new"]))
                window_peak = max(window_peak, occupancy[-1])
                requests += int(seg["n_new"])
                for k in acc:
                    acc[k] += seg[k]
            nxt = src.next_chunk()
            while nxt is not None and nxt.n_real == 0:
                nxt = src.next_chunk()
            frontier = (np.inf if nxt is None
                        else float(nxt.t[nxt.valid][0]))
            params = dict(base.params)
            params.update(tbl)
            params["frontier"] = torch.tensor(frontier, dtype=dt, device=dev)
            cap = budget if max_steps is None else min(budget, int(max_steps))
            carry, i = run_engine_facade(params, key, placement="single",
                                         segment=(carry, i, cap), **st_)
            n_segments += 1
            pending = nxt

        # residual working set + accumulators -> summary
        o = {k: v.cpu().numpy() for k, v in carry.items()}
        t32 = tbl["t_arr"].cpu().numpy()
        t_arr = t32.astype(np.float64)
        D = tbl["D"].cpu().numpy().astype(np.float64)
        st = o["st"]
        t_first = o["t_first"].astype(np.float64)
        t_last = o["t_last"].astype(np.float64)
        arrivals = int(acc["ret"]) + int((st != _NOT_ARRIVED).sum())
        completions = int(acc["done"]) + int((st == _DONE).sum())
        emitted = np.isfinite(t_first)
        ttft_sum = acc["ttft_sum"] + float(
            (t_first[emitted] - t_arr[emitted]).sum())
        ttft_n = acc["ttft_n"] + float(emitted.sum())
        tpm = (st == _DONE) & (D > 1)
        tpot_sum = acc["tpot_sum"] + float(
            ((t_last[tpm] - t_first[tpm])
             / np.maximum(D[tpm] - 1.0, 1.0)).sum())
        tpot_n = acc["tpot_n"] + float(tpm.sum())
        ap = int(o["aptr"])
        A = float(tbl["A"])
        next_arr = float(t_arr[ap]) if ap < A else np.inf
        next_t = min(next_arr, float(o["t_next"].min(initial=np.inf)))
        horizon = self.h_eff if self.h_eff > 0 else 1.0
        nan = float("nan")
        if self.telemetry is not None:
            # rows still in the window never hit a splice fold: bucket
            # their latencies now (the same working-precision values the
            # splice fold sees)
            edges = self._tlm_edges.cpu().numpy()
            for key_, tmark, m in (
                    ("tlm_ttft", o["t_first"], emitted),
                    ("tlm_e2e", o["t_last"], st == _DONE)):
                h = o[key_].astype(np.float64, copy=True)
                np.add.at(h, np.searchsorted(edges, tmark[m] - t32[m]), 1.0)
                o[key_] = h
        telemetry = (extract_probes(o, self.telemetry, horizon=horizon,
                                    n_servers=self._base.n)
                     if self.telemetry is not None else None)
        return {
            "revenue_rate": float(o["rev"]) / horizon,
            "completion_rate": completions / arrivals if arrivals else 0.0,
            "ttft_mean": ttft_sum / ttft_n if ttft_n else nan,
            "ttft_p95": nan,  # not computable from streamed scalars
            "ttft_p99": nan,
            "tpot_mean": tpot_sum / tpot_n if tpot_n else nan,
            "tpot_p95": nan,
            "tpot_p99": nan,
            "completions": completions,
            "arrivals": arrivals,
            "abandons": int(o["abandons"]),
            "t_end": float(o["t"]),
            "budget_exhausted": float(next_t <= self.h_eff),
            "n_iters": float(o["n_iters"]),
            "n_events": float(o["n_events"]),
            "n_loop": float(o["n_loop"]),
            "n_steps": float(i),
            "n_dropped": 0.0,
            "requests": requests,
            "n_segments": n_segments,
            "window_peak": window_peak,
            "window_occupancy": occupancy,
            **({"telemetry": telemetry} if telemetry is not None else {}),
        }
