"""CLI for the workload-scenario subsystem.

    # catalog
    PYTHONPATH=src python -m repro_torch.workloads.run --list

    # generate one scenario, print trace stats (optionally save CSV)
    PYTHONPATH=src python -m repro_torch.workloads.run --scenario rate_shift \
        --stats --seed 3 --out rate_shift.csv

    # closed-loop comparison (adaptive vs static vs heuristics)
    PYTHONPATH=src python -m repro_torch.workloads.run --scenario rate_shift \
        --closed-loop --n 8 --quick [--device cpu]

``--closed-loop`` solves the cold-start and hindsight plans with the
batched planner on ``--device`` (the card by default; the run fails
without one unless ``--device cpu``), replays every variant on the host
and prints one row per variant; with ``--out`` it writes the full
comparison payload as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from repro_torch.compat import resolve_device
from repro_torch.sweep.run import fmt_table

from .closed_loop import (ClosedLoopConfig, compare_policies,
                          plans_for_scenarios)
from .scenarios import get_scenario, list_scenarios

__all__ = ["main"]


def _catalog_rows():
    rows = []
    for name in list_scenarios():
        s = get_scenario(name)
        rows.append({
            "scenario": name,
            "classes": len(s.profiles),
            "arrivals": type(s.arrivals).__name__,
            "mean_rate": round(s.arrivals.mean_rate(s.horizon), 2),
            "horizon": s.horizon,
            "events": len(s.capacity_events),
            "tags": ",".join(s.tags),
        })
    return rows


def _trace_stats(scn, trace, horizon: float) -> dict:
    per_cls = np.bincount([r.cls for r in trace], minlength=scn.n_classes)
    return {
        "scenario": scn.name,
        "n_requests": len(trace),
        "mean_rate": round(len(trace) / max(horizon, 1e-9), 2),
        "per_class": {scn.class_names[i]: int(per_cls[i])
                      for i in range(scn.n_classes)},
        "mean_P": round(float(np.mean([r.prompt_len for r in trace])), 1)
        if trace else 0.0,
        "mean_D": round(float(np.mean([r.decode_len for r in trace])), 1)
        if trace else 0.0,
        "finite_patience": int(sum(np.isfinite(r.patience) for r in trace)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads.run",
        description="Workload scenarios: catalog, generation, closed loop.")
    ap.add_argument("--list", action="store_true",
                    help="print the scenario catalog and exit")
    ap.add_argument("--scenario", default=None,
                    help="scenario name (see --list)")
    ap.add_argument("--stats", action="store_true",
                    help="generate the scenario and print trace statistics")
    ap.add_argument("--closed-loop", action="store_true",
                    help="run the adaptive-vs-static comparison")
    ap.add_argument("--variants", default="adaptive,static,static_cold,vllm",
                    help="comma-separated closed-loop variants")
    ap.add_argument("--n", type=int, default=8, help="cluster size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=float, default=None,
                    help="override the scenario horizon (seconds)")
    ap.add_argument("--compression", type=float, default=1.0,
                    help="interarrival compression (TraceConfig semantics)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="multiply arrival intensity directly")
    ap.add_argument("--quick", action="store_true",
                    help="60 s horizon, light load (CI smoke sizing)")
    ap.add_argument("--out", default=None,
                    help="write trace CSV (--stats) or JSON (--closed-loop)")
    ap.add_argument("--device", default=None,
                    help="where --closed-loop's batched planner runs "
                         "(default: the CUDA card; 'cpu' on the host)")
    args = ap.parse_args(argv)

    if args.list:
        print(fmt_table(_catalog_rows(),
                        ["scenario", "classes", "arrivals", "mean_rate",
                         "horizon", "events", "tags"],
                        f"\n[workloads] {len(list_scenarios())} registered "
                        f"scenarios"))
        return 0

    if not args.scenario:
        ap.error("--scenario is required unless --list is given")
    scn = get_scenario(args.scenario)
    horizon = args.horizon
    rate_scale = args.rate_scale
    if args.quick:
        horizon = min(60.0, horizon or scn.horizon)
        rate_scale = rate_scale * 0.5

    if args.closed_loop:
        dev = resolve_device(args.device)
        cfg = ClosedLoopConfig(n_servers=args.n, horizon=horizon,
                               compression=args.compression,
                               rate_scale=rate_scale, seed=args.seed)
        trace = scn.generate(seed=cfg.seed, horizon=cfg.horizon,
                             compression=cfg.compression,
                             rate_scale=cfg.rate_scale)
        (plans,) = plans_for_scenarios([scn], [trace], [cfg], device=dev)
        res = compare_policies(scn, cfg,
                               variants=tuple(
                                   v for v in args.variants.split(",") if v),
                               trace=trace, plans=plans)
        rows = [
            dict(variant=v,
                 revenue_rate=round(m["revenue_rate"], 2),
                 completion=round(m["completion_rate"], 3),
                 drops=int(m["drops"]),
                 ttft_p95=round(m["ttft_p95"], 2),
                 replans=int(m["replans"]))
            for v, m in res["variants"].items()
        ]
        print(fmt_table(rows, ["variant", "revenue_rate", "completion",
                               "drops", "ttft_p95", "replans"],
                        f"\n[workloads:{scn.name}] closed loop, "
                        f"n={res['n']}, {res['n_requests']} requests"))
        if "adaptive_lead_pct" in res:
            print(f"[workloads:{scn.name}] adaptive vs hindsight-static: "
                  f"{res['adaptive_lead_pct']:+.1f}% revenue rate")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(res, indent=1))
            print(f"[workloads:{scn.name}] wrote {args.out}")
        return 0

    # default / --stats: generate and describe
    trace = scn.generate(seed=args.seed, horizon=horizon,
                         compression=args.compression, rate_scale=rate_scale)
    stats = _trace_stats(scn, trace, horizon or scn.horizon)
    print(json.dumps(stats, indent=1))
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        # numeric class ids: load_trace_csv renumbers unknown *names* by
        # first appearance, so names would not round-trip the indices
        with path.open("w") as f:
            f.write("t,class,P,D,patience\n")
            for r in trace:
                f.write(f"{r.t_arrival},{r.cls},"
                        f"{r.prompt_len},{r.decode_len},{r.patience}\n")
        print(f"[workloads:{scn.name}] wrote {len(trace)} requests to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
