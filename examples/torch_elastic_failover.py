"""Fault tolerance with the PyTorch port: server failures, recovery, and
straggler mitigation.

The reference's ``examples/elastic_failover.py`` through ``repro_torch``.
At t=150s three servers fail (their in-flight prefills/decodes are
re-queued and re-prefilled); at t=300s they recover; one surviving server
runs 3x slow from t=150s.  The online controller observes capacity
changes and replans the LP each time, so the mixed/solo split tracks the
shrunken and restored cluster.

The engine, the controller and the simplex are framework-free, so this
runs on the host and takes no ``--device``; its numbers equal the
reference's bit for bit.

Run:  PYTHONPATH=src python examples/torch_elastic_failover.py
"""

from repro_torch.core.online import OnlineController, OnlineControllerConfig
from repro_torch.core.planning import solve_bundled_lp
from repro_torch.core.policies import gate_and_route
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass
from repro_torch.data.traces import (TraceConfig, synth_azure_trace,
                                     trace_class_means)
from repro_torch.serving.engine_sim import ClusterEngine, EngineConfig


def main(*, n: int = 12, horizon: float = 600.0, compression: float = 0.06,
         seed: int = 3, fail_at: float = 150.0,
         recover_at: float = 300.0) -> dict:
    """The reference's constants as defaults; returns each run's summary."""
    prim = ServicePrimitives()
    pricing = Pricing()
    trace = synth_azure_trace(TraceConfig(horizon=horizon,
                                          compression=compression, seed=seed))
    means = trace_class_means(trace, 2)  # [(P_mean, D_mean, rate), ...]
    classes = [
        WorkloadClass(f"class{i}", prompt_len=means[i][0],
                      decode_len=means[i][1], arrival_rate=means[i][2] / n,
                      patience=3e-4)
        for i in range(2)
    ]
    plan = solve_bundled_lp(classes, prim, pricing)

    events = [
        (fail_at, "fail", 0), (fail_at, "fail", 1), (fail_at, "fail", 2),
        (fail_at, "straggle", 3, 3.0),          # server 3 runs 3x slow
        (recover_at, "recover", 0), (recover_at, "recover", 1),
        (recover_at, "recover", 2),
        (recover_at, "straggle", 3, 1.0),
    ]

    out = {}
    for name, evs in (("healthy cluster", []), ("failures+straggler", events)):
        controller = OnlineController(
            classes, prim, pricing, n=n,
            config=OnlineControllerConfig(window=30.0, replan_every=10.0))
        eng = ClusterEngine(classes, gate_and_route(plan),
                            EngineConfig(prim, pricing, n),
                            controller=controller)
        m = eng.run(trace, horizon=horizon, failure_events=evs)
        s = m.summary()
        print(f"{name:20s} revenue/s={s['revenue_rate']:8.2f} "
              f"completions={s['completions']:4d} "
              f"ttft_p99={s['ttft_p99']:.2f}s mean={s['ttft_mean']:.2f}s")
        out[name] = s
    return out


if __name__ == "__main__":
    main()
