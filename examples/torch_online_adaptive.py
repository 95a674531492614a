"""Online adaptive control on a nonstationary workload scenario, with the
PyTorch port.

The reference's ``examples/online_adaptive.py`` through ``repro_torch``.
The controller estimates class arrival rates from a rolling window
(Eq. 50), re-solves the planning LP every 10 s, and retargets the
mixed/solo split (Eq. 51).  This demo uses the registry's `rate_shift`
scenario (arrival rate steps 2.5x at t = 120 s and the class mix flips)
and shows two things:

1. the rolling-window estimator *tracking* the shift: estimated
   vs true per-class rates, window by window
   (``trace_class_means_windowed`` is the ground truth);
2. the closed loop beating the same policy frozen on the hindsight
   static plan and on the cold-start plan
   (``repro_torch.workloads.closed_loop``).

The controller, the simplex replans and the replays are framework-free,
so this runs on the host and takes no ``--device``; its numbers equal the
reference's bit for bit.

Run:  PYTHONPATH=src python examples/torch_online_adaptive.py
"""

import numpy as np

from repro_torch.core.online import OnlineController, OnlineControllerConfig
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass
from repro_torch.data.traces import (trace_class_means,
                                     trace_class_means_windowed)
from repro_torch.workloads import (ClosedLoopConfig, compare_policies,
                                   get_scenario)


def main(*, n: int = 8, window: float = 30.0, scenario: str = "rate_shift",
         seed: int = 0, horizon=None) -> dict:
    """The reference's constants as defaults (``horizon=None`` is the
    scenario's own); returns the rate table and the comparison."""
    prim = ServicePrimitives()
    pricing = Pricing()

    scn = get_scenario(scenario)
    trace = scn.generate(seed=seed, horizon=horizon)

    # -- 1) estimated vs true rates over time -------------------------------
    means = trace_class_means(trace, scn.n_classes)
    classes = [
        WorkloadClass(scn.class_names[i], prompt_len=means[i][0],
                      decode_len=means[i][1], arrival_rate=means[i][2] / n,
                      patience=3e-4)
        for i in range(scn.n_classes)
    ]
    ctrl = OnlineController(
        classes, prim, pricing, n=n,
        config=OnlineControllerConfig(window=window, replan_every=10.0,
                                      safety=1.0))

    truth = trace_class_means_windowed(trace, scn.n_classes, window)
    it = iter(trace)
    r = next(it, None)
    print(f"rolling-window estimator vs truth ({scn.name}, "
          f"window={window:.0f}s, shift at t=120s)")
    print(f"{'window':>12s} | {'true rate/s':>18s} | "
          f"{'estimated rate/s':>18s}")
    rows = []
    for t0, t1, w_means in truth:
        while r is not None and r.t_arrival < t1:
            ctrl.observe_arrival(r.t_arrival, r.cls)
            r = next(it, None)
        # estimate_rates returns per-server rates inflated by the safety
        # factor; undo both to compare with the cluster-level truth
        lam_hat = ctrl.estimate_rates(t1) * n / ctrl.cfg.safety
        true_rates = [w_means[i][2] for i in range(scn.n_classes)]
        print(f"[{t0:4.0f},{t1:4.0f}) | "
              + np.array2string(np.array(true_rates), precision=2).rjust(18)
              + " | "
              + np.array2string(lam_hat, precision=2).rjust(18))
        rows.append((t0, t1, true_rates, lam_hat.tolist()))

    # -- 2) closed loop vs frozen plans -------------------------------------
    res = compare_policies(scn, ClosedLoopConfig(n_servers=n, seed=seed,
                                                 horizon=horizon),
                           variants=("adaptive", "static", "static_cold"))
    print(f"\nclosed loop on {scn.name} (n={n}, {res['n_requests']} "
          f"requests):")
    for name, m in res["variants"].items():
        print(f"{name:12s} revenue/s={m['revenue_rate']:8.2f} "
              f"completion={m['completion_rate']:.3f} "
              f"ttft_p95={m['ttft_p95']:6.2f}s replans={int(m['replans'])}")
    print(f"adaptive vs hindsight-static: {res['adaptive_lead_pct']:+.1f}% "
          f"revenue rate")
    return {"rates": rows, "compare": res}


if __name__ == "__main__":
    main()
