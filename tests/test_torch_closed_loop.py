"""The port's closed loop (``repro_torch.workloads.closed_loop``) and the
workloads CLI held to the reference on the CPU.

The closed loop is framework-free (the Python engine, the online
controller, the simplex): its metric dicts are held bit for bit,
``rate_shift`` at ``bench_scenarios.py``'s full size among them (the
adaptive lead 5.374133740330568, ``artifacts/bench/scenarios.json``).
``plans_for_scenarios`` runs the batched interior point: within 1e-6 of
the reference's (its float64 IPM under ``enable_x64``).
"""

import json

import numpy as np
import pytest

from repro.workloads import closed_loop as RL
from repro_torch.workloads import closed_loop as TL

LEAD = 5.374133740330568


def test_rate_shift_full_size_comparison_is_the_reference():
    cfg = dict(n_servers=8, seed=0)
    got = TL.compare_policies("rate_shift", TL.ClosedLoopConfig(**cfg))
    want = RL.compare_policies("rate_shift", RL.ClosedLoopConfig(**cfg))
    assert got == want
    assert got["adaptive_lead_pct"] == LEAD
    assert got["n_requests"] == 6865


@pytest.mark.parametrize("scenario,variant", [
    ("capacity_churn", "adaptive"), ("link_degrade", "adaptive"),
    ("capacity_churn", "static_cold"), ("flash_crowd", "sarathi"),
])
def test_small_replays_are_the_reference(scenario, variant):
    cfg = dict(n_servers=6, horizon=60.0, seed=3, rate_scale=0.5)
    got = TL.run_closed_loop(scenario, variant, TL.ClosedLoopConfig(**cfg))
    want = RL.run_closed_loop(scenario, variant, RL.ClosedLoopConfig(**cfg))
    assert got == want


def test_plans_for_scenarios_within_1e6_of_the_reference():
    from repro.compat import enable_x64
    from repro_torch.workloads import get_scenario

    names = ("rate_shift", "flash_crowd", "azure_2023")
    cfgs = [TL.ClosedLoopConfig(n_servers=8, horizon=120.0, seed=s)
            for s in range(3)]
    traces = [get_scenario(n).generate(seed=c.seed, horizon=c.horizon)
              for n, c in zip(names, cfgs)]
    got = TL.plans_for_scenarios(names, traces, cfgs, device="cpu")
    rcfgs = [RL.ClosedLoopConfig(n_servers=8, horizon=120.0, seed=s)
             for s in range(3)]
    with enable_x64():
        want = RL.plans_for_scenarios(names, traces, rcfgs)
    for g, w in zip(got, want):
        for cls_g, cls_w in ((g[0], w[0]), (g[2], w[2])):
            assert [c.arrival_rate for c in cls_g] == [
                c.arrival_rate for c in cls_w]
        for pg, pw in ((g[1], w[1]), (g[3], w[3])):
            assert pg.revenue_rate == pytest.approx(pw.revenue_rate,
                                                    rel=1e-6)
            np.testing.assert_allclose(pg.x, pw.x, atol=1e-6)
    with pytest.raises(ValueError, match="align"):
        TL.plans_for_scenarios(names, traces[:2], cfgs, device="cpu")


def test_batched_plans_keep_the_lead_and_the_riders(tmp_path):
    """compare_policies on plans from the batched planner, the trace and
    manifest riders, and the reference's trace file byte for byte."""
    from repro_torch.telemetry.manifest import read_records, validate_record
    from repro_torch.telemetry.trace import validate_trace
    from repro_torch.workloads import get_scenario

    scn = get_scenario("rate_shift")
    cfg = TL.ClosedLoopConfig(n_servers=8, horizon=90.0, seed=0)
    trace = scn.generate(seed=0, horizon=90.0)
    (plans,) = TL.plans_for_scenarios([scn], [trace], [cfg], device="cpu")
    simplex = TL.compare_policies(scn, cfg, variants=("adaptive", "static"),
                                  trace=trace)
    batched = TL.compare_policies(scn, cfg, variants=("adaptive", "static"),
                                  trace=trace, plans=plans)
    assert batched["adaptive_lead_pct"] == pytest.approx(
        simplex["adaptive_lead_pct"], abs=1e-6)
    a, m = tmp_path / "a.json", tmp_path / "m.jsonl"
    got = TL.run_closed_loop(scn, "adaptive", cfg, trace=trace,
                             trace_path=a, manifest_path=m)
    b = tmp_path / "b.json"
    want = RL.run_closed_loop("rate_shift", "adaptive",
                              RL.ClosedLoopConfig(n_servers=8, horizon=90.0,
                                                  seed=0), trace_path=b)
    assert got == want
    assert a.read_bytes() == b.read_bytes()
    assert validate_trace(a) == []
    (rec,) = read_records(m)
    assert validate_record(rec) == [] and rec["kind"] == "closed_loop"
    assert list(rec["artifacts"]) == [str(a)]
    with pytest.raises(ValueError, match="variant"):
        TL.run_closed_loop(scn, "oracle", cfg, trace=trace)


def test_workloads_cli(tmp_path, capsys):
    from repro.workloads.run import main as ref_main
    from repro_torch.workloads.run import main

    assert main(["--list"]) == 0
    port_list = capsys.readouterr().out
    assert ref_main(["--list"]) == 0
    assert port_list == capsys.readouterr().out

    csv = tmp_path / "t.csv"
    assert main(["--scenario", "flash_crowd", "--stats", "--seed", "2",
                 "--horizon", "30", "--out", str(csv)]) == 0
    port_stats = capsys.readouterr().out
    ref_csv = tmp_path / "r.csv"
    assert ref_main(["--scenario", "flash_crowd", "--stats", "--seed", "2",
                     "--horizon", "30", "--out", str(ref_csv)]) == 0
    assert csv.read_bytes() == ref_csv.read_bytes()
    assert (port_stats.replace(str(csv), "")
            == capsys.readouterr().out.replace(str(ref_csv), ""))

    out = tmp_path / "cl.json"
    assert main(["--scenario", "rate_shift", "--closed-loop", "--quick",
                 "--horizon", "30", "--variants", "adaptive,static",
                 "--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert set(res["variants"]) == {"adaptive", "static"}
    assert "adaptive vs hindsight-static" in capsys.readouterr().out


def test_workloads_cli_closed_loop_needs_a_card_unless_cpu():
    import torch

    from repro_torch.workloads.run import main

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scenario", "rate_shift", "--closed-loop", "--quick"])
