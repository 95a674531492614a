"""CLI for the port's telemetry subsystem.

    PYTHONPATH=src python -m repro_torch.telemetry report --scenario rate_shift
    PYTHONPATH=src python -m repro_torch.telemetry validate trace.json
    PYTHONPATH=src python -m repro_torch.telemetry validate-manifest runs.jsonl

``report`` replays one registered workload scenario through the Python
engine (on the host) with probes ON and renders the time-binned
trajectories plus the SLI percentiles as terminal tables; ``--out``
additionally writes the Chrome-trace JSON (open in chrome://tracing or
Perfetto) and ``--manifest`` appends a ``telemetry`` RunRecord.
``validate`` / ``validate-manifest`` are the schema gates for every
emitted artifact (the port's RunRecord schema,
:mod:`repro_torch.telemetry.manifest`).  No subcommand touches a device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .manifest import (append_record, file_digest, read_records, run_record,
                       validate_record)
from .probes import hist_attainment, resolve_probe_spec
from .trace import validate_trace

__all__ = ["main"]


def _sparkline(vals, width: int = 48) -> str:
    """Down-sampled unicode sparkline of one trajectory."""
    blocks = " .:-=+*#%@"
    v = np.asarray(vals, dtype=np.float64)
    if v.size > width:
        edge = np.linspace(0, v.size, width + 1).astype(int)
        v = np.array([v[a:b].mean() if b > a else 0.0
                      for a, b in zip(edge[:-1], edge[1:])])
    hi = float(v.max())
    if hi <= 0:
        return blocks[0] * v.size
    idx = np.clip((v / hi * (len(blocks) - 1)).round().astype(int),
                  0, len(blocks) - 1)
    return "".join(blocks[i] for i in idx)


def _report(args) -> int:
    from repro_torch.workloads.closed_loop import ClosedLoopConfig
    from repro_torch.workloads.scenarios import get_scenario

    scn = get_scenario(args.scenario)
    horizon = float(args.horizon if args.horizon is not None
                    else min(scn.horizon, 60.0))
    spec = resolve_probe_spec(True)
    cfg = ClosedLoopConfig(n_servers=args.n, horizon=horizon,
                           seed=args.seed)
    t0 = time.time()

    # run through the Python engine (full lifecycle timestamps) and
    # keep the metrics object for its telemetry report
    from repro_torch.core.types import Pricing, ServicePrimitives
    from repro_torch.serving.engine_sim import ClusterEngine, EngineConfig
    from repro_torch.workloads.closed_loop import _plans

    prim, pricing = ServicePrimitives(), Pricing()
    trace = scn.generate(seed=cfg.seed, horizon=horizon)
    _cold_cls, _cold, full_cls, full_plan = _plans(
        scn, trace, cfg, prim, pricing)
    from repro_torch.core.policies import gate_and_route

    eng = ClusterEngine(
        full_cls, gate_and_route(full_plan),
        EngineConfig(prim, pricing, args.n, seed=cfg.seed, telemetry=spec))
    metrics = eng.run(trace, horizon=horizon)
    tl = metrics.telemetry
    wall = time.time() - t0

    print(f"[telemetry] scenario={scn.name} n={args.n} "
          f"horizon={horizon:g}s seed={cfg.seed} "
          f"({len(trace)} requests, {wall:.2f}s wall)")
    print(f"  bins: {tl['spec']['n_bins']} x {tl['bin_width']:.3g}s, "
          f"hist: {tl['spec']['n_hist']} buckets "
          f"[{tl['spec']['hist_min']:g}, {tl['spec']['hist_max']:g}]s")
    print("\n  trajectory (per bin)        min     mean      max  shape")
    rows = [("queue_depth", tl["queue_depth"].sum(axis=-1)),
            ("decode_occupancy", tl["decode_occupancy"]),
            ("prefill_in_flight", tl["prefill_in_flight"])]
    if "busy_fraction" in tl:
        rows.append(("busy_fraction", tl["busy_fraction"]))
    for name, v in rows:
        print(f"  {name:<22} {v.min():>8.2f} {v.mean():>8.2f} "
              f"{v.max():>8.2f}  {_sparkline(v)}")
    print(f"\n  counters: events={tl['events'].sum():.0f} "
          f"drops={tl['drops'].sum():.0f} "
          + (f"admits={tl['admits'].sum():.0f}" if "admits" in tl else ""))
    print("\n  SLI (from on-device histograms)   p50      p95      p99"
          "    <=1s")
    for sli in ("ttft", "e2e"):
        if f"{sli}_p50" not in tl:
            continue
        att = hist_attainment(tl[f"{sli}_hist"], tl["hist_edges"], 1.0)
        print(f"  {sli:<30} {tl[f'{sli}_p50']:>8.3f} "
              f"{tl[f'{sli}_p95']:>8.3f} {tl[f'{sli}_p99']:>8.3f} "
              f"{100 * att:>6.1f}%")

    artifacts = {}
    if args.out:
        from .trace import lifecycle_events, write_trace

        p = write_trace(args.out, lifecycle_events(eng.lifecycle_records()),
                        source=f"telemetry-report/{scn.name}")
        errs = validate_trace(p)
        if errs:
            print(f"[telemetry] ERROR: emitted trace invalid: {errs[:3]}",
                  file=sys.stderr)
            return 1
        artifacts[str(p)] = file_digest(p)
        print(f"\n  wrote trace {p} (load in chrome://tracing)")
    if args.manifest:
        rec = run_record(kind="telemetry", name=f"report/{scn.name}",
                         wall_s=wall,
                         extra={"n": args.n, "horizon": horizon,
                                "seed": cfg.seed,
                                "events": float(tl["events"].sum())},
                         artifacts=artifacts)
        mp = append_record(rec, args.manifest)
        print(f"  appended RunRecord to {mp}")
    return 0


def _validate(args) -> int:
    errs = validate_trace(args.path)
    if errs:
        print(f"[telemetry] {args.path}: INVALID ({len(errs)} errors)")
        for e in errs[:20]:
            print(f"  - {e}")
        return 1
    import json
    from pathlib import Path

    n = len(json.loads(Path(args.path).read_text())["traceEvents"])
    print(f"[telemetry] {args.path}: valid trace ({n} events)")
    return 0


def _validate_manifest(args) -> int:
    bad = 0
    total = 0
    try:
        for i, rec in enumerate(read_records(args.path)):
            total += 1
            errs = validate_record(rec)
            if errs:
                bad += 1
                print(f"[telemetry] {args.path}:{i + 1}: "
                      f"{'; '.join(errs[:5])}")
    except (OSError, ValueError) as exc:
        print(f"[telemetry] {args.path}: unreadable ({exc})")
        return 1
    if bad:
        print(f"[telemetry] {args.path}: {bad}/{total} records INVALID")
        return 1
    print(f"[telemetry] {args.path}: {total} valid records")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Render telemetry reports; validate trace-event and "
                    "manifest artifacts.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report",
                        help="replay a scenario with probes on and print "
                             "trajectory + SLI tables")
    rp.add_argument("--scenario", default="rate_shift",
                    help="registered workload scenario name")
    rp.add_argument("--n", type=int, default=8, help="cluster size")
    rp.add_argument("--horizon", type=float, default=None,
                    help="replay horizon (default: min(scenario, 60s))")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--out", default=None,
                    help="write the Chrome-trace JSON here")
    rp.add_argument("--manifest", default=None,
                    help="append a RunRecord to this JSONL manifest")
    rp.set_defaults(fn=_report)

    vp = sub.add_parser("validate",
                        help="schema-check a trace-event JSON file")
    vp.add_argument("path")
    vp.set_defaults(fn=_validate)

    mp = sub.add_parser("validate-manifest",
                        help="schema-check a RunRecord JSONL manifest")
    mp.add_argument("path")
    mp.set_defaults(fn=_validate_manifest)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
