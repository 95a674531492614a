"""Chrome-trace / Perfetto ``trace_event`` JSON export.

Renders request lifecycles and closed-loop replan epochs as a browsable
timeline: load the emitted file in ``chrome://tracing`` or
https://ui.perfetto.dev.  The format is the Trace Event Format's JSON
object form -- ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with
``"X"`` (complete) events carrying ``ts``/``dur`` in *microseconds* and
``"i"`` (instant) events marking replans.

Inputs are plain *lifecycle records*: one dict per request with
``rid``/``cls`` plus the timestamps the engines track anyway --
``t_arr`` (arrival), optional ``t_admit`` (prefill start) and
``t_prefill_done`` (the Python engine knows these), ``t_first`` (first
decode emission) and ``t_last`` (last emission).  The batched engines
(``serving/engine_jax.py``) only carry arrival/first/last, so their
queue-wait and prefill spans merge into one ``wait+prefill`` span; the
Python engine renders all three phases.  :func:`validate_trace` is the
schema gate for every emitted file.

A framework-free copy of the reference's ``repro.telemetry.trace``: the
same events, payloads and checks.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Iterable, Optional

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "lifecycle_events",
    "replan_events",
    "trace_payload",
    "validate_trace",
    "write_trace",
]

TRACE_SCHEMA_VERSION = 1

_PID_REQUESTS = 1
_PID_CONTROL = 2
_PHASES = ("queue", "prefill", "wait+prefill", "decode")


def _us(t: float) -> float:
    return float(t) * 1e6


def _finite(v) -> bool:
    return v is not None and math.isfinite(float(v))


def _span(name: str, cat: str, tid: int, t0: float, t1: float,
          args: Optional[dict] = None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "X", "ts": _us(t0),
          "dur": max(_us(t1) - _us(t0), 0.0), "pid": _PID_REQUESTS,
          "tid": int(tid)}
    if args:
        ev["args"] = args
    return ev


def lifecycle_events(records: Iterable[dict]) -> list:
    """Trace events for request lifecycles.

    Each record renders up to three spans on its own track (``tid`` =
    request id): the queue wait (arrival -> prefill admit), the prefill
    span (admit -> prefill done) and the decode span (first -> last
    emission).  Records without admit/prefill-done timestamps (the
    batched engines) merge the first two into one ``wait+prefill`` span
    ending at the first emission.
    """
    events = []
    for r in records:
        rid = int(r["rid"])
        cat = str(r.get("cls", "request"))
        t_arr = r.get("t_arr")
        t_admit = r.get("t_admit")
        t_pfd = r.get("t_prefill_done")
        t_first = r.get("t_first")
        t_last = r.get("t_last")
        args = {"state": r.get("state", "")} if r.get("state") else None
        if _finite(t_arr) and _finite(t_admit):
            events.append(_span("queue", cat, rid, t_arr, t_admit, args))
            if _finite(t_pfd):
                events.append(_span("prefill", cat, rid, t_admit, t_pfd))
        elif _finite(t_arr) and _finite(t_first):
            events.append(
                _span("wait+prefill", cat, rid, t_arr, t_first, args))
        if _finite(t_first) and _finite(t_last):
            events.append(_span("decode", cat, rid, t_first, t_last))
    return events


def replan_events(replans: Iterable) -> list:
    """Instant events for closed-loop replan epochs.  Each entry is a
    time (seconds) or a ``(time, args-dict)`` pair."""
    events = []
    for rp in replans:
        if isinstance(rp, (tuple, list)):
            t, args = rp[0], dict(rp[1])
        else:
            t, args = rp, None
        ev = {"name": "replan", "cat": "control", "ph": "i",
              "ts": _us(t), "pid": _PID_CONTROL, "tid": 0, "s": "g"}
        if args:
            ev["args"] = args
        events.append(ev)
    return events


def trace_payload(events: list, *, source: str = "repro") -> dict:
    return {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "otherData": {"schema_version": TRACE_SCHEMA_VERSION,
                      "source": source},
    }


def write_trace(path, events: list, *, source: str = "repro") -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(trace_payload(events, source=source)))
    return p


def validate_trace(obj) -> list:
    """Schema check for an emitted trace (parsed JSON or a path);
    returns error strings (empty = valid Trace Event Format)."""
    if isinstance(obj, (str, Path)):
        try:
            obj = json.loads(Path(obj).read_text())
        except (OSError, json.JSONDecodeError) as exc:
            return [f"unreadable trace file: {exc}"]
    errors = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    sv = (obj.get("otherData") or {}).get("schema_version")
    if sv is not None and (not isinstance(sv, int)
                           or sv > TRACE_SCHEMA_VERSION or sv < 1):
        errors.append(f"otherData.schema_version {sv!r} outside "
                      f"[1, {TRACE_SCHEMA_VERSION}]")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: event must be an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errors.append(f"{where}: ph {ph!r} not one of X/i/M")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                errors.append(f"{where}: missing {key!r}")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or not math.isfinite(ts):
                errors.append(f"{where}: ts must be a finite number")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float))
                    or not math.isfinite(dur) or dur < 0):
                errors.append(f"{where}: dur must be a finite "
                              f"non-negative number")
            if ev.get("name") in _PHASES and ev.get("pid") != _PID_REQUESTS:
                errors.append(f"{where}: lifecycle span on pid "
                              f"{ev.get('pid')!r} (expected "
                              f"{_PID_REQUESTS})")
        if len(errors) > 50:
            errors.append("... (further errors suppressed)")
            break
    return errors
