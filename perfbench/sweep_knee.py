"""Find a cell's knee on the card: the highest offered rate without a
growing backlog, and the iteration times the plan's primitives are fitted
from.

    python3 perfbench/sweep_knee.py --workload <cell> --rates 3,3.5,4 \
        --seconds 30 --seed 7 --out chiprun_out/knee.json [--write]
    python3 perfbench/sweep_knee.py --workload <cell> --apply knee.json

One process sets the cell up once and serves each rate on a fresh engine
for the mix's lead and ``--seconds``. A rate's backlog grows where the
queued requests' least-squares slope over the window passes 2% of the
rate a second. ``--write`` (or ``--apply`` of a saved sweep) writes the
knee into the swept mix (``knee``, and ``rate`` = ``rate_of_knee`` x
knee) and into every mix whose ``knee_from`` names it, and the fitted
primitives into the cell's configuration: alpha the mean mixed iteration
(the engine pads every chunk to C, so its time does not depend on the
chunk's real tokens and beta is 0 at one C) and gamma one over the mean
solo iteration.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

GROWTH = 0.02  # backlog slope, as a share of the rate, that counts as growth


def sweep_rate(cell, rate: float, seconds: float, seed: int) -> dict:
    import numpy as np

    from perfbench import stats

    classes, plan, gate = cell.plan(rate)
    engine = cell.engine()
    rec = cell.serve(engine, gate, len(classes), seed, seconds, rate)
    del engine
    pts = [(t, q) for t, q in rec.backlog if rec.open <= t < rec.close]
    slope = float(np.polyfit(*zip(*pts), 1)[0]) if len(pts) > 2 else 0.0
    done = [r for r in rec.requests
            if r.done and rec.open <= r.token_times[-1] < rec.close]
    n_mix = sum(it.mode == "mixed" and rec.open <= it.t0 < rec.close
                for it in rec.iterations)
    n_solo = sum(it.mode == "solo" and rec.open <= it.t0 < rec.close
                 for it in rec.iterations)
    return {"rate": rate, "backlog_slope": slope,
            "backlog_end": pts[-1][1] if pts else 0,
            "completed_per_s": len(done) / seconds,
            "ttft_p95_ms": 1e3 * stats.p95(stats.ttft(rec)),
            "tau_mix_ms": 1e3 * stats.tau(rec, "mixed"),
            "tau_solo_ms": 1e3 * (stats.tau(rec, "solo") or float("nan")),
            "n_mixed": n_mix, "n_solo": n_solo,
            "grows": slope > GROWTH * rate}


def knee_of(rows) -> dict:
    ok = []
    for r in sorted(rows, key=lambda r: r["rate"]):
        if r["grows"]:
            break
        ok.append(r)
    if not ok:
        raise SystemExit("every swept rate grows a backlog: sweep lower")
    n_mix = sum(r["n_mixed"] for r in rows)
    n_solo = sum(r["n_solo"] for r in rows if r["n_solo"])
    tau_mix = sum(r["tau_mix_ms"] * r["n_mixed"] for r in rows) / n_mix
    tau_solo = sum(r["tau_solo_ms"] * r["n_solo"] for r in rows
                   if r["n_solo"]) / n_solo
    return {"knee": ok[-1]["rate"], "alpha": tau_mix / 1e3, "beta": 0.0,
            "gamma": 1e3 / tau_solo, "rows": rows}


def apply(workload: str, result: dict, note: str):
    from perfbench import harness

    bench = harness.load_bench(ROOT)
    spec = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_path = ROOT / "perfbench" / "configs" / f"{spec['config']}.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["primitives"] = {"alpha": result["alpha"], "beta": 0.0,
                         "gamma": result["gamma"], "fitted_from": note}
    cfg_path.write_text(json.dumps(cfg, indent=2) + "\n")
    for path in sorted((ROOT / "perfbench" / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        if path.stem == spec["traffic"] \
                or mix.get("knee_from") == spec["traffic"]:
            mix["knee"] = result["knee"]
            mix["rate"] = round(mix["rate_of_knee"] * result["knee"], 6)
            path.write_text(json.dumps(mix, indent=2) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", help="where to write the sweep's JSON")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--apply", help="a saved sweep's JSON to write in")
    args = ap.parse_args(argv)
    if args.apply:
        res = json.loads(Path(args.apply).read_text())
        apply(args.workload, res, res["note"])
        return 0

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    cell = harness.Cell(bench, args.workload, args.seed, "cuda")
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        rows.append(sweep_rate(cell, rate, args.seconds, args.seed))
        print(json.dumps(rows[-1]), flush=True)
    res = knee_of(rows)
    res["note"] = (f"sweep_knee.py, {len(rows)} rates x {args.seconds:g} s "
                   f"on {torch.cuda.get_device_name()}, "
                   f"{time.strftime('%Y-%m-%d')}")
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=2) + "\n")
    if args.write:
        apply(args.workload, res, res["note"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
