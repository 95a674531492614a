"""Window arithmetic on a run's record: what the end-to-end metrics and
the admission layer's metric read. Times are seconds on the driver's
clock; every request due inside the window counts, and one that has not
reached the event by the close counts at its wait so far."""

from __future__ import annotations

import numpy as np

__all__ = ["in_window", "ttft", "queue_wait", "tpot_gaps", "revenue_per_s",
           "p95", "tau"]


def p95(values) -> float | None:
    return float(np.percentile(values, 95)) if len(values) else None


def in_window(rec):
    return [r for r in rec.requests if rec.open <= r.due < rec.close]


def _censored(rec, t_event, r):
    return (t_event if t_event < rec.close else rec.close) - r.due


def ttft(rec) -> list:
    """Due to first output token, per request due in the window."""
    return [_censored(rec, r.token_times[0] if r.token_times
                      else float("inf"), r) for r in in_window(rec)]


def queue_wait(rec) -> list:
    """Due to ``start_prefill``, per request due in the window."""
    return [_censored(rec, r.admitted if r.admitted == r.admitted
                      else float("inf"), r) for r in in_window(rec)]


def tpot_gaps(rec) -> list:
    """Every gap between consecutive output tokens of one request whose
    later token came inside the window."""
    out = []
    for r in rec.requests:
        t = r.token_times
        out.extend(b - a for a, b in zip(t, t[1:])
                   if rec.open <= b < rec.close)
    return out


def revenue_per_s(rec, c_p: float, c_d: float) -> float:
    """c_p P + c_d D over requests completed in the window, per second of
    the window."""
    done = [r for r in rec.requests
            if r.done and rec.open <= r.token_times[-1] < rec.close]
    w = sum(c_p * r.prompt_len + c_d * r.decode_len for r in done)
    return w / (rec.close - rec.open)


def tau(rec, mode: str, skip=None) -> float | None:
    """Mean host wall of the window's iterations of ``mode``; ``skip``
    is an (first, last) range of iteration indices left out (the traced
    ones, which the profiler slows)."""
    lo, hi = skip if skip else (-1, -2)
    ts = [it.t1 - it.t0 for k, it in enumerate(rec.iterations)
          if it.mode == mode and rec.open <= it.t0 < rec.close
          and not lo <= k <= hi]
    return float(np.mean(ts)) if ts else None
