"""The port's batched planner held to the JAX package and the simplex.

``repro_torch.core.lp_jax`` (the fixed-iteration interior point, torch
float64) and ``repro_torch.core.planning_batch`` run on the CPU here over
the corpus of ``tests/test_lp_jax.py``.  Objectives agree with the serial
simplex and with the reference's ``lp_jax`` to a relative 1e-6 (the
contract of ``docs/PLANNING.md``: the IPM stops at relative residuals of
1e-9, and degenerate LPs have alternate optimal vertices, so vertices are
not compared), and the ``converged`` flags are the reference's.
"""

import copy

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.core import lp_jax as ref_lp_jax
from repro.core import planning_batch as ref_pb
from repro.core import types as ref_types
from repro_torch.core import lp as lp_mod
from repro_torch.core.lp import LPInfeasible, linprog_max
from repro_torch.core.lp_jax import linprog_max_jax, solve_lp_batch
from repro_torch.core.online import (OnlineController, OnlineControllerConfig,
                                     replan_controllers_batch)
from repro_torch.core.planning import SLISpec, solve_bundled_lp, solve_plan
from repro_torch.core.planning_batch import (PAD_LAM, solve_hetero_batch,
                                             solve_hetero_plan,
                                             solve_plan_batch, solve_plan_jax)
from repro_torch.core.types import (Pricing, ServicePrimitives, WorkloadClass,
                                    rate_arrays)

REL_TOL = 1e-6  # the documented objective tolerance vs the oracle
CPU = dict(device="cpu")

C0 = WorkloadClass("decode_heavy", 300, 1000, 0.5, 0.1)
C1 = WorkloadClass("prefill_heavy", 3000, 400, 0.5, 0.1)
MID = WorkloadClass("mid", 800, 600, 0.3, 0.05)
PRIM = ServicePrimitives()
PRICE = Pricing(c_p=0.1, c_d=0.2)

# tests/test_lp_jax.py's PLAN_CORPUS: every SLI structure the planner takes
PLAN_CORPUS = [
    ("bundled", dict(objective="bundled")),
    ("separate", dict(objective="separate")),
    ("pin_qd", dict(sli=SLISpec(pin_zero_decode_queue=True))),
    ("tpot_cap", dict(sli=SLISpec(tpot_cap=0.024))),
    ("prefill_cap", dict(sli=SLISpec(prefill_fairness_cap=0.01))),
    ("decode_cap", dict(sli=SLISpec(decode_fairness_cap=0.5))),
    ("prefill_pen", dict(sli=SLISpec(prefill_fairness_penalty=1e4))),
    ("both_pen", dict(sli=SLISpec(prefill_fairness_penalty=100.0,
                                  decode_fairness_penalty=10.0))),
]


def rel_err(a, b):
    return abs(a - b) / (1.0 + abs(a))


def _ref_classes(classes):
    return tuple(ref_types.WorkloadClass(c.name, c.prompt_len, c.decode_len,
                                         c.arrival_rate, c.patience)
                 for c in classes)


def _ref_sli(sli):
    if sli is None:
        return None
    from repro.core.planning import SLISpec as RefSLI

    return RefSLI(**{f: getattr(sli, f) for f in sli.__dataclass_fields__})


def check_plan_feasible(plan, tol=1e-6):
    arr = rate_arrays(plan.classes, plan.prim)
    B = plan.prim.batch_cap
    assert plan.x.sum() <= 1 + tol
    assert plan.ym.sum() <= (B - 1) * plan.x.sum() + tol
    assert plan.ys.sum() <= B * (1 - plan.x.sum()) + tol
    np.testing.assert_allclose(
        arr["mu_p"] * plan.x + arr["theta"] * plan.qp, arr["lam"], atol=1e-5)
    np.testing.assert_allclose(
        arr["mu_p"] * plan.x - arr["theta"] * plan.qd,
        arr["mu_m"] * plan.ym + arr["mu_s"] * plan.ys, atol=1e-5)
    for v in (plan.x, plan.ym, plan.ys, plan.qp, plan.qd):
        assert np.all(v >= -tol)


# (c, A_ub, b_ub, A_eq, b_eq, objective): tests/test_lp_jax.py's textbook,
# equality and redundant-row instances
LP_CASES = [
    ([3, 5], [[1, 0], [0, 2], [3, 2]], [4, 12, 18], None, None, 36.0),
    ([1, 2], None, None, [[1, 1]], [1], 2.0),
    ([1, 1], [[1, 0]], [0.25], [[1, 1], [2, 2]], [1, 2], 1.0),
]


@pytest.mark.parametrize("case", range(len(LP_CASES)))
def test_small_lps_match_oracle_and_reference(case):
    c, A_ub, b_ub, A_eq, b_eq, want = LP_CASES[case]
    got = linprog_max_jax(c, A_ub, b_ub, A_eq, b_eq, **CPU)
    ref = ref_lp_jax.linprog_max_jax(c, A_ub, b_ub, A_eq, b_eq)
    assert bool(got.converged) == bool(ref.converged) is True
    assert got.fun == pytest.approx(want, abs=1e-6)
    assert rel_err(float(ref.fun), float(got.fun)) < REL_TOL
    if case < 2:  # the redundant rows of case 2 split their dual freely
        np.testing.assert_allclose(got.dual_ub, ref.dual_ub, atol=1e-6)
        np.testing.assert_allclose(got.dual_eq, ref.dual_eq, atol=1e-6)


def test_batch_values_match_per_instance_solves():
    rng = np.random.default_rng(7)
    n, m, S = 4, 3, 8
    cs, As, bs = [], [], []
    for _ in range(S):
        cs.append(rng.normal(size=n))
        As.append(np.vstack([rng.normal(size=(m, n)), np.ones((1, n))]))
        bs.append(np.concatenate([rng.uniform(0.5, 2.0, size=m), [5.0]]))
    res = solve_lp_batch(np.stack(cs), np.stack(As), np.stack(bs), **CPU)
    ref = ref_lp_jax.solve_lp_batch(np.stack(cs), np.stack(As), np.stack(bs))
    np.testing.assert_array_equal(res.converged, ref.converged)
    assert res.converged.all()
    for k in range(S):
        oracle = linprog_max(cs[k], As[k], bs[k])
        assert rel_err(oracle.fun, res.fun[k]) < REL_TOL
        assert rel_err(ref.fun[k], res.fun[k]) < REL_TOL
        # strong duality holds batched too
        assert rel_err(res.fun[k], float(bs[k] @ res.dual_ub[k])) < 1e-5


def test_converged_flags_match_on_unbounded_and_infeasible_lps():
    """Instances the IPM cannot solve: the flags are the reference's
    (False), nothing raises, and the solvable row beside them converges."""
    c = np.array([[1.0, 1.0], [1.0, 1.0], [1.0, 1.0]])
    A_ub = np.array([[[1.0, -1.0]], [[1.0, 1.0]], [[1.0, 1.0]]])
    b_ub = np.array([[1.0], [-1.0], [2.0]])  # unbounded, infeasible, fine
    got = solve_lp_batch(c, A_ub, b_ub, **CPU)
    ref = ref_lp_jax.solve_lp_batch(c, A_ub, b_ub)
    np.testing.assert_array_equal(got.converged, ref.converged)
    assert got.converged.tolist() == [False, False, True]
    assert rel_err(float(ref.fun[2]), float(got.fun[2])) < REL_TOL


@pytest.mark.parametrize("label,kw", PLAN_CORPUS)
def test_planning_corpus_agrees_with_oracle_and_reference(label, kw):
    oracle = solve_plan([C0, C1], PRIM, PRICE, **kw)
    pb = solve_plan_batch([(C0, C1)], PRIM, PRICE, **kw, **CPU)
    rkw = dict(kw)
    if "sli" in rkw:
        rkw["sli"] = _ref_sli(rkw["sli"])
    ref = ref_pb.solve_plan_batch([_ref_classes((C0, C1))],
                                  ref_types.ServicePrimitives(),
                                  ref_types.Pricing(c_p=0.1, c_d=0.2), **rkw)
    np.testing.assert_array_equal(pb.converged, ref.converged)
    assert bool(pb.converged[0]), (label, pb.primal_res, pb.dual_res)
    sol = pb.solution(0)
    assert rel_err(oracle.revenue_rate, sol.revenue_rate) < REL_TOL
    assert rel_err(float(ref.revenue_rate[0]), sol.revenue_rate) < REL_TOL
    assert rel_err(oracle.sli_value, sol.sli_value) < 1e-4
    assert pb.meta == ref.meta
    check_plan_feasible(sol)


@pytest.mark.parametrize("sli", [None, SLISpec(prefill_fairness_cap=0.05),
                                 SLISpec(prefill_fairness_penalty=100.0)],
                         ids=["plain", "fairness_cap", "fairness_penalty"])
def test_mixed_class_counts_pad_and_agree(sli):
    """Instances of 1, 2 and 3 classes in one batch: the PAD_LAM filler
    never anchors a pairwise row; each instance matches its own simplex
    solve and the reference's padded batch."""
    insts = [(C0, C1), (C0, C1, MID), (C0,)]
    pb = solve_plan_batch(insts, PRIM, PRICE, sli=sli, **CPU)
    ref = ref_pb.solve_plan_batch([_ref_classes(i) for i in insts],
                                  ref_types.ServicePrimitives(),
                                  ref_types.Pricing(c_p=0.1, c_d=0.2),
                                  sli=_ref_sli(sli))
    np.testing.assert_array_equal(pb.converged, ref.converged)
    assert pb.converged.all() and PAD_LAM == ref_pb.PAD_LAM
    for k, inst in enumerate(insts):
        oracle = solve_bundled_lp(inst, PRIM, PRICE, sli=sli)
        sol = pb.solution(k)
        assert len(sol.x) == len(inst)  # padding sliced off
        assert rel_err(oracle.revenue_rate, sol.revenue_rate) < REL_TOL
        assert rel_err(float(ref.revenue_rate[k]), sol.revenue_rate) \
            < REL_TOL
        if sli is None:
            check_plan_feasible(sol)


def test_caps_capacity_and_pricing_axes():
    caps = np.linspace(1e-4, 2.0, 5)
    pb = solve_plan_batch([(C0, C1)] * len(caps), PRIM, PRICE,
                          sli=SLISpec(decode_fairness_cap=caps), **CPU)
    assert pb.converged.all()
    for k, cap in enumerate(caps):
        oracle = solve_bundled_lp((C0, C1), PRIM, PRICE,
                                  sli=SLISpec(decode_fairness_cap=float(cap)))
        assert rel_err(oracle.revenue_rate, pb.revenue_rate[k]) < REL_TOL
    assert np.all(np.diff(pb.revenue_rate) >= -1e-6)
    pricings = [Pricing(0.1, 0.2), Pricing(0.2, 0.1), Pricing(0.05, 0.4)]
    capacity = [1.0, 0.5, 2.0]
    pb = solve_plan_batch([(C0, C1)] * 3, PRIM, pricings=pricings,
                          capacity=capacity, **CPU)
    assert pb.converged.all()
    for k in range(3):
        oracle = solve_plan((C0, C1), PRIM, pricings[k],
                            capacity=capacity[k])
        assert rel_err(oracle.revenue_rate, pb.revenue_rate[k]) < REL_TOL


def test_infeasible_instance_raises_lp_infeasible():
    """The batched path never publishes a garbage plan where the simplex
    raises: non-convergence becomes LPInfeasible, as in the reference."""
    hot = (WorkloadClass("hot", 300, 1000, 50.0, 0.0),)
    with pytest.raises(LPInfeasible):
        solve_plan(list(hot), PRIM, PRICE)
    with pytest.raises(LPInfeasible, match="did not converge"):
        solve_plan_jax(hot, PRIM, PRICE, **CPU)
    ref = ref_pb.solve_plan_batch([_ref_classes(hot)],
                                  ref_types.ServicePrimitives(),
                                  ref_types.Pricing(c_p=0.1, c_d=0.2))
    got = solve_plan_batch([hot], PRIM, PRICE, **CPU)
    np.testing.assert_array_equal(got.converged, ref.converged)
    assert LPInfeasible is lp_mod.LPInfeasible


def test_solve_plan_jax_is_plan_solution_compatible():
    sol = solve_plan_jax((C0, C1), PRIM, PRICE, **CPU)
    oracle = solve_bundled_lp((C0, C1), PRIM, PRICE)
    assert rel_err(oracle.revenue_rate, sol.revenue_rate) < REL_TOL
    assert sol.mixed_servers(10) == oracle.mixed_servers(10)
    probs = sol.solo_probs()
    assert probs.shape == (2,) and np.all((0 <= probs) & (probs <= 1))


def test_hetero_plan_agrees_with_reference():
    """Two server classes (a fast and a half-speed pool, one with a KV
    transfer charge), both objectives, and the C = 1 degeneration to the
    homogeneous plan."""
    slow = dict(alpha=2 * PRIM.alpha, beta=2 * PRIM.beta,
                gamma=PRIM.gamma / 2, batch_cap=8)
    fleet = [(3.0, PRIM, 0.0), (1.0, ServicePrimitives(**slow), 1e-4)]
    rfleet = [(3.0, ref_types.ServicePrimitives(), 0.0),
              (1.0, ref_types.ServicePrimitives(**slow), 1e-4)]
    for objective in ("bundled", "separate"):
        got = solve_hetero_plan((C0, C1), fleet, PRICE, objective=objective,
                                **CPU)
        ref = ref_pb.solve_hetero_plan(_ref_classes((C0, C1)), rfleet,
                                       ref_types.Pricing(c_p=0.1, c_d=0.2),
                                       objective=objective)
        assert rel_err(ref.revenue_rate, got.revenue_rate) < REL_TOL
        np.testing.assert_allclose(got.split_probs(), ref.split_probs(),
                                   atol=1e-5)
        assert rel_err(ref.pool_plan(0).revenue_rate,
                       got.pool_plan(0).revenue_rate) < 1e-5
    hb = solve_hetero_batch([(C0, C1)], [[(1.0, PRIM, 0.0)]], PRICE, **CPU)
    hom = solve_plan_batch([(C0, C1)], PRIM, PRICE, **CPU)
    assert hb.converged.all()
    assert rel_err(float(hom.revenue_rate[0]), float(hb.revenue_rate[0])) \
        < REL_TOL


def _controller(solver, seed=3, n=10, t_end=20.0, count=300):
    rng = np.random.default_rng(seed)
    ctl = OnlineController((C0, C1), PRIM, PRICE, n=n,
                           config=OnlineControllerConfig(solver=solver,
                                                         device="cpu"))
    for t in np.sort(rng.uniform(0, t_end, count)):
        ctl.observe_arrival(float(t), int(rng.integers(0, 2)))
    return ctl


def test_online_controller_lp_jax_solver_matches_simplex():
    a = _controller("simplex").replan(20.0)
    b = _controller("lp_jax").replan(20.0)
    assert rel_err(a.revenue_rate, b.revenue_rate) < REL_TOL
    np.testing.assert_allclose(a.x, b.x, atol=1e-5)
    assert a.mixed_servers(10) == b.mixed_servers(10)


def test_replan_controllers_batch_matches_serial_replans():
    ctls = [_controller("simplex", seed=11 + k, n=8, t_end=15.0,
                        count=80 + 60 * k) for k in range(3)]
    refs = [copy.deepcopy(c) for c in ctls]
    plans = replan_controllers_batch(ctls, 15.0)
    assert len(plans) == 3
    for ctl, ref in zip(ctls, refs):
        ref.replan(15.0)
        assert ctl.replan_count == 1
        assert ctl._next_replan >= 15.0 + ctl.cfg.replan_every
        assert rel_err(ref.plan.revenue_rate, ctl.plan.revenue_rate) \
            < REL_TOL
    other = _controller("simplex")
    other.cfg = OnlineControllerConfig(objective="separate", device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        replan_controllers_batch([ctls[0], other], 15.0)
    assert replan_controllers_batch([], 15.0) == []
