"""Time ``ctmc_scan`` on the card at the optimality-gap path's shapes.

    PYTHONPATH=src python3 src/repro_torch/kernels/ctmc_scan/bench.py \\
        [--cases check,n16,gap] [--label TEXT]

Runs against whichever ``repro_torch`` is first on ``PYTHONPATH``, so two
checkouts compare in one call on one card (run as a file, it imports
nothing beside itself).  The instance is ``chip_smoke.py`` phase 7's
(``benchmarks/bench_optimality_gap.py``'s overloaded mix, float64, I=2):

- ``gap``: the main path's launch, n=16 (2 schemes x 32 seeds, horizon
  300) and n=65536 (2 x 3, horizon 100) in one call, once;
- ``n16``: its n=16 cells alone, median of 3;
- ``check``: phase 7's check call, n=16 (2 x 8, horizon 40) and n=65536
  (2 x 2, horizon 0.03), median of 5.

Prints one JSON line per case: host wall ms between synchronizes, launches,
the longest replication's steps and ns a step over it, events in all, and
the sum of revenue and of events (equal across checkouts when the streams
and the arithmetic are), beside the card's name and power limit, and the
SM clock ``nvidia-smi`` read every 200 ms during the case (its median
turns ns into cycles a step).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# benchmarks/bench_optimality_gap.py's OVERLOADED_MIX: (name, prompt,
# decode, lambda, patience)
GAP_CLASSES = (("decode-heavy", 300, 1000, 1.0, 0.1),
               ("prefill-heavy", 3000, 400, 1.0, 0.1))
# case -> ((n, seeds, horizon, warmup), ...), schemes, reps
CASES = {
    "gap": (((16, 32, 300.0, 75.0), (65536, 3, 100.0, 50.0)),
            ("bundled", "separate"), 1),
    "n16": (((16, 32, 300.0, 75.0),), ("bundled", "separate"), 3),
    "check": (((16, 8, 40.0, 10.0), (65536, 2, 0.03, 0.0075)),
              ("bundled", "separate"), 5),
}


def _policies():
    from repro_torch.core.planning import solve_bundled_lp, solve_separate_lp
    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import (Pricing, ServicePrimitives,
                                        WorkloadClass)

    classes = [WorkloadClass(nm, p, d, arrival_rate=lam, patience=th)
               for nm, p, d, lam, th in GAP_CLASSES]
    prim, pricing = ServicePrimitives(), Pricing()
    pol = {"bundled": gate_and_route(solve_bundled_lp(classes, prim,
                                                      pricing)),
           "separate": gate_and_route(
               solve_separate_lp(classes, prim, pricing),
               name="gate_and_route_separate").replace(charging="separate")}
    return classes, prim, pricing, pol


def _run(case: str) -> dict:
    from repro_torch.core.ctmc_jax import UniformizedCTMC, run_cells_raw
    from repro_torch.kernels.ctmc_scan.ops import ctmc_scan

    rows, schemes, reps = CASES[case]
    classes, prim, pricing, pol = _policies()
    cells = [(UniformizedCTMC(classes, prim, pricing, pol[sch], n=n,
                              horizon=h, warmup=w, dtype=torch.float64),
              list(range(seeds)))
             for n, seeds, h, w in rows for sch in schemes]
    times = []
    for _ in range(reps):
        n0 = ctmc_scan.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raws = run_cells_raw(cells)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        launches = ctmc_scan.launches - n0
    ms = sorted(times)[len(times) // 2]
    steps = max(float(r["n_events"].max()) for r in raws)
    events = sum(float(r["n_events"].sum()) for r in raws)
    return {"case": case, "replications": sum(len(s) for _, s in cells),
            "ms": ms, "ms_all": times, "launches": launches,
            "steps_max": steps, "ns_per_step": 1e6 * ms / steps,
            "events": events, "events_per_s": events / ms * 1e3,
            "rev_sum": sum(float(r["rev"].sum()) for r in raws)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="check,n16,gap")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for case in args.cases.split(","):
        clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, text=True)
        try:
            out = _run(case)
        finally:
            clocks.terminate()
        mhz = sorted(float(v) for v in clocks.communicate()[0].split()
                     if v.replace(".", "").isdigit())
        if mhz:
            med = mhz[len(mhz) // 2]
            out.update(sm_mhz=[mhz[0], med, mhz[-1]],
                       cycles_per_step=out["ns_per_step"] * med / 1e3)
        out.update(label=args.label, device=torch.cuda.get_device_name(0), nvidia_smi=smi)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
