"""Batched trace replay with the port's iteration-level engine.

The reference's ``examples/engine_jax_demo.py`` through ``repro_torch``.
The paper's Table 2 / Fig. 4 policy comparison replays a calibrated
trace through the per-server scheduling simulator.  This example runs an
Azure-like synthetic trace under three policy families in
`repro_torch.serving.engine_jax.ClusterEngineJAX` -- each policy an 8-
replication batch (on the card, the step in CUDA graphs) -- and
cross-checks gate-and-route against the exact Python event loop
(`repro_torch.serving.engine_sim.ClusterEngine`, the semantics oracle).
On the CUDA card by default; ``--device cpu`` runs the step on the host.

Run:  PYTHONPATH=src python examples/torch_engine_jax_demo.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.planning import solve_bundled_lp
from repro_torch.core.policies import (baseline_sarathi, baseline_vllm,
                                       gate_and_route)
from repro_torch.core.types import Pricing, ServicePrimitives
from repro_torch.data.traces import TraceConfig, synth_azure_trace
from repro_torch.serving.engine_jax import ClusterEngineJAX
from repro_torch.serving.engine_sim import ClusterEngine, EngineConfig
from repro_torch.sweep.evaluators import planner_classes_from_trace


def main(*, n: int = 10, reps: int = 8, horizon: float = 30.0,
         base_rate: float = 2.0, compression: float = 0.06, seed: int = 42,
         device=None) -> dict:
    """The reference's constants as defaults; returns the printed numbers."""
    prim, price = ServicePrimitives(), Pricing(c_p=0.1, c_d=0.2)
    tcfg = TraceConfig(horizon=horizon, base_rate=base_rate,
                       compression=compression, seed=seed)
    trace = synth_azure_trace(tcfg)
    classes = planner_classes_from_trace(trace, n)
    plan = solve_bundled_lp(classes, prim, price)
    print(f"{len(trace)} requests over {tcfg.horizon}s, n={n} servers")

    policies = [
        ("gate_and_route", gate_and_route(plan), {}),
        ("vllm", baseline_vllm(plan), {}),
        ("sarathi", baseline_sarathi(plan), dict(sarathi_budget=True)),
    ]
    out = {}
    for name, pol, kw in policies:
        cfg = EngineConfig(prim, price, n_servers=n, **kw)
        eng = ClusterEngineJAX(classes, pol, cfg, trace,
                               horizon=tcfg.horizon, device=device)
        res = eng.run_batch(range(reps))
        rev = [m["revenue_rate"] for m in res]
        print(f"{name:15s} revenue/s = {np.mean(rev):8.2f}  "
              f"ttft_p95 = {res[0]['ttft_p95']:.3f}s  "
              f"completions = {res[0]['completions']:.0f}  "
              f"({reps} reps, step budget {eng.n_steps}, "
              f"budget_exhausted={res[0]['budget_exhausted']:.0f})")
        out[name] = res

    # same trajectory law as the exact Python event loop (the oracle)
    cfg = EngineConfig(prim, price, n_servers=n)
    m = ClusterEngine(classes, gate_and_route(plan), cfg).run(
        trace, horizon=tcfg.horizon).summary()
    print(f"python oracle    revenue/s = {m['revenue_rate']:8.2f}  "
          f"ttft_p95 = {m['ttft_p95']:.3f}s  "
          f"completions = {m['completions']:.0f}")
    out["oracle"] = m
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
