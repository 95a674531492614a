"""The port's framework-free carry-overs held bitwise to the JAX package:
the simplex, the planning LPs, traces, and the per-server ClusterEngine."""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.calibration.models import AffineModel as RefAffineModel
from repro.core import lp as ref_lp
from repro.core import planning as ref_planning
from repro.core import policies as ref_policies
from repro.core import types as ref_types
from repro.data import traces as ref_traces
from repro.serving import engine_sim as ref_engine
from repro_torch.calibration.models import AffineModel
from repro_torch.core import lp, planning, policies, types
from repro_torch.core.online import OnlineController, OnlineControllerConfig
from repro_torch.data import traces
from repro_torch.serving import engine_sim
from repro_torch.telemetry.probes import ProbeSpec

# (c, A_ub, b_ub, A_eq, b_eq): the instances of tests/test_lp.py
LP_CASES = [
    ([3, 5], [[1, 0], [0, 2], [3, 2]], [4, 12, 18], None, None),
    ([1, 2], None, None, [[1, 1]], [1]),
    ([1, 1], [[1, 0]], [0.25], [[1, 1], [2, 2]], [1, 2]),
]


@pytest.mark.parametrize("case", range(len(LP_CASES)))
def test_linprog_max_bitwise(case):
    c, A_ub, b_ub, A_eq, b_eq = LP_CASES[case]
    want = ref_lp.linprog_max(c, A_ub, b_ub, A_eq, b_eq)
    got = lp.linprog_max(c, A_ub, b_ub, A_eq, b_eq)
    assert got.fun == want.fun
    for f in ("x", "dual_ub", "dual_eq"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("args,exc", [
    (([1], [[1]], [-1], [[1]], [5]), "LPInfeasible"),
    (([1, 0], [[0, 1]], [1]), "LPUnbounded"),
])
def test_linprog_max_raises_like_reference(args, exc):
    with pytest.raises(getattr(ref_lp, exc)):
        ref_lp.linprog_max(*args)
    with pytest.raises(getattr(lp, exc)):
        lp.linprog_max(*args)


def _classes(mod):
    # the paper's EC.8.5 synthetic instance (tests/test_planning.py)
    return [mod.WorkloadClass("decode_heavy", prompt_len=300, decode_len=1000,
                              arrival_rate=0.5, patience=0.1),
            mod.WorkloadClass("prefill_heavy", prompt_len=3000,
                              decode_len=400, arrival_rate=0.5, patience=0.1)]


SLI_CASES = [None, dict(pin_zero_decode_queue=True), dict(tpot_cap=0.03),
             dict(prefill_fairness_cap=0.01),
             dict(prefill_fairness_penalty=1e4)]


def _assert_plans_equal(got, want):
    assert got.revenue_rate == want.revenue_rate
    assert got.sli_value == want.sli_value
    for f in ("x", "ym", "ys", "qp", "qd", "dual_capacity"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("solver", ["solve_bundled_lp", "solve_separate_lp"])
@pytest.mark.parametrize("sli", range(len(SLI_CASES)))
def test_planning_lp_bitwise(solver, sli):
    kw = SLI_CASES[sli]
    want = getattr(ref_planning, solver)(
        _classes(ref_types), ref_types.ServicePrimitives(),
        ref_types.Pricing(c_p=0.1, c_d=0.2),
        sli=None if kw is None else ref_planning.SLISpec(**kw))
    got = getattr(planning, solver)(
        _classes(types), types.ServicePrimitives(),
        types.Pricing(c_p=0.1, c_d=0.2),
        sli=None if kw is None else planning.SLISpec(**kw))
    _assert_plans_equal(got, want)
    assert got.mixed_servers(10) == want.mixed_servers(10)
    np.testing.assert_array_equal(got.solo_probs(), want.solo_probs())
    assert planning.tpot_of_plan(got) == ref_planning.tpot_of_plan(want)


def test_planning_lp_bitwise_random_instances():
    rng = np.random.default_rng(7)
    for _ in range(12):
        n_cls = int(rng.integers(1, 5))
        rows = [(float(rng.uniform(50, 4000)), float(rng.uniform(20, 2000)),
                 float(rng.uniform(0.01, 1.5)), float(rng.uniform(0.01, 0.5)))
                for _ in range(n_cls)]
        B = int(rng.integers(4, 33))
        want = ref_planning.solve_bundled_lp(
            [ref_types.WorkloadClass(f"c{i}", *r) for i, r in enumerate(rows)],
            ref_types.ServicePrimitives(batch_cap=B),
            ref_types.Pricing(c_p=0.1, c_d=0.2))
        got = planning.solve_bundled_lp(
            [types.WorkloadClass(f"c{i}", *r) for i, r in enumerate(rows)],
            types.ServicePrimitives(batch_cap=B),
            types.Pricing(c_p=0.1, c_d=0.2))
        _assert_plans_equal(got, want)


@pytest.mark.parametrize("cfg", [
    dict(horizon=40.0, base_rate=2.0, compression=0.08, seed=42),
    dict(horizon=120.0, base_rate=3.0, compression=0.2, seed=3),
])
def test_synth_azure_trace_bitwise(cfg):
    want = ref_traces.synth_azure_trace(ref_traces.TraceConfig(**cfg))
    got = traces.synth_azure_trace(traces.TraceConfig(**cfg))
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert traces.trace_class_means(got, 2) == \
        ref_traces.trace_class_means(want, 2)


def _replay(tr, ty, pl, po, eng, model_cls, policy, *, model_kw=None,
            n=6, horizon=30.0, telemetry=None):
    trace = tr.synth_azure_trace(tr.TraceConfig(
        horizon=horizon, base_rate=2.0, compression=0.08, seed=5))
    means = tr.trace_class_means(trace, 2)
    classes = [ty.WorkloadClass(nm, m[0], m[1], m[2] / n, patience=3e-4)
               for nm, m in zip(("code", "conv"), means)]
    model = model_cls(**(model_kw or {}))
    prim = model.primitives()
    pricing = ty.Pricing(c_p=0.1, c_d=0.2)
    plan = pl.solve_bundled_lp(classes, prim, pricing,
                               sli=pl.SLISpec(pin_zero_decode_queue=True))
    cfg = eng.EngineConfig(prim=prim, pricing=pricing, n_servers=n,
                           iter_model=model, telemetry=telemetry)
    m = eng.ClusterEngine(classes, getattr(po, policy)(plan), cfg).run(
        trace, horizon)
    return m


FITTED = dict(alpha=0.0032877654682647523, beta=5.0155610964467e-06,
              a_s=0.003286678203428373, b_s=1.061782066776979e-09,
              name="fitted")


@pytest.mark.parametrize("policy", ["gate_and_route", "baseline_vllm",
                                    "baseline_sarathi", "prioritize_and_route"])
@pytest.mark.parametrize("model_kw", [None, FITTED], ids=["seed", "fitted"])
def test_cluster_engine_summary_bitwise(policy, model_kw):
    want = _replay(ref_traces, ref_types, ref_planning, ref_policies,
                   ref_engine, RefAffineModel, policy, model_kw=model_kw)
    got = _replay(traces, types, planning, policies, engine_sim, AffineModel,
                  policy, model_kw=model_kw)
    np.testing.assert_array_equal(
        np.array(list(got.summary().values()), dtype=float),
        np.array(list(want.summary().values()), dtype=float))
    assert got.summary().keys() == want.summary().keys()
    assert (got.revenue, got.n_iters) == (want.revenue, want.n_iters)


def test_cluster_engine_probes_bitwise():
    want = _replay(ref_traces, ref_types, ref_planning, ref_policies,
                   ref_engine, RefAffineModel, "gate_and_route",
                   telemetry=True)
    got = _replay(traces, types, planning, policies, engine_sim, AffineModel,
                  "gate_and_route", telemetry=ProbeSpec())
    assert got.telemetry.keys() == want.telemetry.keys()
    for k, v in want.telemetry.items():
        np.testing.assert_array_equal(np.asarray(got.telemetry[k]),
                                      np.asarray(v))


def test_online_controller_raises_for_unported_batched_planner():
    classes = _classes(types)
    ctl = OnlineController(
        classes, types.ServicePrimitives(), types.Pricing(), 4,
        config=OnlineControllerConfig(solver="lp_jax"))
    with pytest.raises(NotImplementedError, match="A4"):
        ctl.replan(0.0)
