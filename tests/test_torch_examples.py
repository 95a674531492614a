"""The six examples of the port (``examples/torch_*.py``) run small on the
CPU.  Where an example's work is framework-free (quickstart,
elastic_failover, online_adaptive), its numbers equal the reference
modules' numbers on the same small inputs, bit for bit; the others
(ctmc_jax_demo, engine_jax_demo, serve_cluster) run their device path
through the plain versions and give finite, consistent numbers."""

import importlib.util
import json
import math
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["torch_quickstart", "torch_ctmc_jax_demo",
            "torch_engine_jax_demo", "torch_online_adaptive",
            "torch_elastic_failover", "torch_serve_cluster"]
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)", re.M)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_import_neither_jax_nor_the_reference():
    for name in EXAMPLES + ["torch_train_small"]:
        text = (ROOT / "examples" / f"{name}.py").read_text()
        assert not IMPORT_RE.search(text), name


def test_quickstart_equals_the_reference(capsys):
    from repro.core.planning import solve_bundled_lp
    from repro.core.policies import baseline_sarathi, gate_and_route
    from repro.core.simulator import CTMCSimulator
    from repro.core.types import Pricing, ServicePrimitives, WorkloadClass

    n, horizon, warmup = 20, 40.0, 10.0
    got = _load("torch_quickstart").main(n=n, horizon=horizon, warmup=warmup)
    assert "fluid-optimal per-GPU revenue" in capsys.readouterr().out
    classes = [WorkloadClass("decode-heavy", 300, 1000, 0.5, 0.1),
               WorkloadClass("prefill-heavy", 3000, 400, 0.5, 0.1)]
    prim, pricing = ServicePrimitives(), Pricing(c_p=0.1, c_d=0.2)
    plan = solve_bundled_lp(classes, prim, pricing)
    want = {"R*": plan.revenue_rate, "x": plan.x.tolist(),
            "mixed": plan.mixed_servers(n)}
    for policy in (gate_and_route(plan), baseline_sarathi(plan)):
        res = CTMCSimulator(classes, prim, pricing, policy, n=n,
                            seed=0).run(horizon=horizon, warmup=warmup)
        want[policy.name] = res.revenue_rate_per_server
    assert got == want


def test_elastic_failover_equals_the_reference(capsys):
    from repro.core.online import OnlineController, OnlineControllerConfig
    from repro.core.planning import solve_bundled_lp
    from repro.core.policies import gate_and_route
    from repro.core.types import Pricing, ServicePrimitives, WorkloadClass
    from repro.data.traces import (TraceConfig, synth_azure_trace,
                                   trace_class_means)
    from repro.serving.engine_sim import ClusterEngine, EngineConfig

    kw = dict(n=12, horizon=60.0, compression=0.06, seed=3, fail_at=15.0,
              recover_at=30.0)
    got = _load("torch_elastic_failover").main(**kw)
    assert "failures+straggler" in capsys.readouterr().out
    prim, pricing = ServicePrimitives(), Pricing()
    trace = synth_azure_trace(TraceConfig(horizon=60.0, compression=0.06,
                                          seed=3))
    means = trace_class_means(trace, 2)
    classes = [WorkloadClass(f"class{i}", means[i][0], means[i][1],
                             means[i][2] / 12, patience=3e-4)
               for i in range(2)]
    plan = solve_bundled_lp(classes, prim, pricing)
    events = [(15.0, "fail", 0), (15.0, "fail", 1), (15.0, "fail", 2),
              (15.0, "straggle", 3, 3.0), (30.0, "recover", 0),
              (30.0, "recover", 1), (30.0, "recover", 2),
              (30.0, "straggle", 3, 1.0)]
    for name, evs in (("healthy cluster", []),
                      ("failures+straggler", events)):
        ctrl = OnlineController(classes, prim, pricing, n=12,
                                config=OnlineControllerConfig(
                                    window=30.0, replan_every=10.0))
        m = ClusterEngine(classes, gate_and_route(plan),
                          EngineConfig(prim, pricing, 12),
                          controller=ctrl).run(trace, horizon=60.0,
                                               failure_events=evs)
        assert got[name] == pytest.approx(m.summary(), rel=0, abs=0,
                                          nan_ok=True), name


def test_online_adaptive_equals_the_reference(capsys):
    from repro.core.online import OnlineController, OnlineControllerConfig
    from repro.core.types import Pricing, ServicePrimitives, WorkloadClass
    from repro.data.traces import (trace_class_means,
                                   trace_class_means_windowed)
    from repro.workloads import (ClosedLoopConfig, compare_policies,
                                 get_scenario)

    horizon = 60.0
    got = _load("torch_online_adaptive").main(horizon=horizon)
    assert "adaptive vs hindsight-static" in capsys.readouterr().out
    scn = get_scenario("rate_shift")
    trace = scn.generate(seed=0, horizon=horizon)
    means = trace_class_means(trace, scn.n_classes)
    classes = [WorkloadClass(scn.class_names[i], means[i][0], means[i][1],
                             means[i][2] / 8, patience=3e-4)
               for i in range(scn.n_classes)]
    ctrl = OnlineController(classes, ServicePrimitives(), Pricing(), n=8,
                            config=OnlineControllerConfig(
                                window=30.0, replan_every=10.0, safety=1.0))
    it = iter(trace)
    r = next(it, None)
    rows = []
    for t0, t1, w in trace_class_means_windowed(trace, scn.n_classes, 30.0):
        while r is not None and r.t_arrival < t1:
            ctrl.observe_arrival(r.t_arrival, r.cls)
            r = next(it, None)
        lam = ctrl.estimate_rates(t1) * 8 / ctrl.cfg.safety
        rows.append((t0, t1, [w[i][2] for i in range(scn.n_classes)],
                     lam.tolist()))
    assert got["rates"] == rows
    want = compare_policies(scn, ClosedLoopConfig(n_servers=8, seed=0,
                                                  horizon=horizon),
                            variants=("adaptive", "static", "static_cold"))
    # every number to the last bit (NaN included)
    assert json.dumps(got["compare"], sort_keys=True) == json.dumps(
        want, sort_keys=True)


def test_ctmc_jax_demo_runs_on_the_cpu(capsys):
    out = _load("torch_ctmc_jax_demo").main(
        horizon=6.0, warmup=1.0, reps=4, ns=(4, 8), oracle_n=4,
        oracle_reps=2, device="cpu")
    assert "python oracle at n=4" in capsys.readouterr().out
    assert out["R*"] > 0 and math.isfinite(out["oracle"])
    for n in (4, 8):
        row = out["n"][n]
        assert math.isfinite(row["mean"]) and row["mean"] > 0
        assert row["steps"] > 0


def test_engine_jax_demo_runs_on_the_cpu(capsys):
    out = _load("torch_engine_jax_demo").main(n=4, reps=2, horizon=4.0,
                                              device="cpu")
    assert "python oracle" in capsys.readouterr().out
    for name in ("gate_and_route", "vllm", "sarathi"):
        res = out[name]
        assert len(res) == 2
        assert all(np.isfinite(m["revenue_rate"]) for m in res)
        assert all(m["budget_exhausted"] == 0 for m in res)
    assert out["oracle"]["completions"] > 0


def test_serve_cluster_runs_on_the_cpu(capsys, monkeypatch):
    """The example as a script: it forwards its arguments to
    ``repro_torch.launch.serve.main``."""
    monkeypatch.setattr(sys, "argv", [
        "torch_serve_cluster.py", "--device", "cpu", "--arch",
        "mamba2-130m", "--requests", "4", "--servers", "2"])
    runpy.run_path(str(ROOT / "examples" / "torch_serve_cluster.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "LP plan" in out and "completions" in out
