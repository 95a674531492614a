"""Batched CTMC replications with the port's uniformized engine.

The reference's ``examples/ctmc_jax_demo.py`` through ``repro_torch``.
The EC.8.5 convergence question -- how fast does per-GPU revenue close
the gap to the fluid optimum R* as the cluster grows? -- needs many
independent replications per cluster size.  This example runs a
64-replication batch per n as ONE call each
(`repro_torch.core.ctmc_jax.UniformizedCTMC`: on the card one launch of
the `ctmc_scan` kernel, a warp a replication), cross-checks the smallest
size against the exact Python event loop (same law, tested in
`tests/test_torch_ctmc.py`), and prints the shrinking gap.  On the CUDA
card by default; ``--device cpu`` runs the kernel's plain version.

Run:  PYTHONPATH=src python examples/torch_ctmc_jax_demo.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.ctmc_jax import UniformizedCTMC
from repro_torch.core.planning import solve_bundled_lp
from repro_torch.core.policies import gate_and_route
from repro_torch.core.simulator import CTMCSimulator
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass


def main(*, horizon: float = 60.0, warmup: float = 15.0, reps: int = 64,
         ns=(20, 50, 200), oracle_n: int = 20, oracle_reps: int = 8,
         device=None) -> dict:
    """The reference's constants as defaults; returns the printed numbers."""
    classes = [
        WorkloadClass("decode-heavy", prompt_len=300, decode_len=1000,
                      arrival_rate=0.5, patience=0.1),
        WorkloadClass("prefill-heavy", prompt_len=3000, decode_len=400,
                      arrival_rate=0.5, patience=0.1),
    ]
    prim, pricing = ServicePrimitives(), Pricing(c_p=0.1, c_d=0.2)
    plan = solve_bundled_lp(classes, prim, pricing)
    policy = gate_and_route(plan)
    print(f"fluid-optimal per-GPU revenue R* = {plan.revenue_rate:.3f}/s")

    out = {"R*": plan.revenue_rate, "n": {}}
    for n in ns:
        sim = UniformizedCTMC(classes, prim, pricing, policy, n=n,
                              horizon=horizon, warmup=warmup, device=device)
        rates = [r.revenue_rate_per_server
                 for r in sim.run_batch(range(reps))]
        gap = 100 * (1 - np.mean(rates) / plan.revenue_rate)
        hw = 1.96 * np.std(rates, ddof=1) / np.sqrt(reps)
        print(f"n={n:4d}: revenue/GPU/s = {np.mean(rates):7.3f} ± {hw:.3f} "
              f"({reps} reps, gap to R*: {gap:+.1f}%, "
              f"{sim.n_steps} scan steps)")
        out["n"][n] = {"mean": float(np.mean(rates)), "half_width": hw,
                       "gap_pct": gap, "steps": sim.n_steps}

    # same law as the exact Python event loop (here: a few replications at
    # the smallest size)
    py = CTMCSimulator(classes, prim, pricing, policy, n=oracle_n)
    py_rates = [r.revenue_rate_per_server
                for r in py.run_batch(horizon, warmup=warmup,
                                      rngs=np.random.SeedSequence(0).spawn(
                                          oracle_reps))]
    print(f"python oracle at n={oracle_n}: revenue/GPU/s = "
          f"{np.mean(py_rates):7.3f} ({oracle_reps} reps)")
    out["oracle"] = float(np.mean(py_rates))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
