"""Quickstart with the PyTorch port: plan with the fluid LP, control with
gate-and-route.

The reference's ``examples/quickstart.py`` through ``repro_torch``:
  1. define heterogeneous workload classes (P_i, D_i, lambda_i, theta_i),
  2. solve the steady-state planning LP (Eq. 40) for occupancy targets,
  3. run the stochastic cluster under the gate-and-route policy,
  4. check per-GPU revenue against the fluid optimum R*.

Every step is framework-free (the simplex, the policy, the exact event
loop), so it runs on the host and takes no ``--device``; its numbers
equal the reference's bit for bit.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""

from repro_torch.core.planning import solve_bundled_lp
from repro_torch.core.policies import baseline_sarathi, gate_and_route
from repro_torch.core.simulator import CTMCSimulator
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass


def main(*, n: int = 200, horizon: float = 400.0, warmup: float = 100.0,
         seed: int = 0) -> dict:
    """The reference's constants as defaults; returns the printed numbers."""
    # 1. Workload: a decode-heavy class (creative writing) and a
    #    prefill-heavy class (summarization), with the paper's
    #    A100/Qwen3-8B calibration.
    classes = [
        WorkloadClass("decode-heavy", prompt_len=300, decode_len=1000,
                      arrival_rate=0.5, patience=0.1),
        WorkloadClass("prefill-heavy", prompt_len=3000, decode_len=400,
                      arrival_rate=0.5, patience=0.1),
    ]
    prim = ServicePrimitives()  # alpha=0.0174, beta=6.2e-5, B=16, C=256
    pricing = Pricing(c_p=0.1, c_d=0.2)

    # 2. Fluid planning LP
    plan = solve_bundled_lp(classes, prim, pricing)
    print(f"fluid-optimal per-GPU revenue R* = {plan.revenue_rate:.3f}/s")
    print(f"prefill occupancy targets x*     = {plan.x.round(4)}")
    print(f"mixed GPUs out of {n}            = {plan.mixed_servers(n)}")
    out = {"R*": plan.revenue_rate, "x": plan.x.tolist(),
           "mixed": plan.mixed_servers(n)}

    # 3. Stochastic system under gate-and-route vs a Sarathi-style heuristic
    for policy in (gate_and_route(plan), baseline_sarathi(plan)):
        sim = CTMCSimulator(classes, prim, pricing, policy, n=n, seed=seed)
        res = sim.run(horizon=horizon, warmup=warmup)
        gap = 100 * (1 - res.revenue_rate_per_server / plan.revenue_rate)
        print(f"{policy.name:18s} revenue/GPU/s = "
              f"{res.revenue_rate_per_server:.3f}  (gap to fluid: "
              f"{gap:+.1f}%)")
        out[policy.name] = res.revenue_rate_per_server
    return out


if __name__ == "__main__":
    main()
