"""The port's fluid model held to the JAX package and to the LP.

``repro_torch.core.fluid`` runs its Euler loop on the host over torch
tensors.  In float64 its trajectories match the reference's
``integrate_fluid`` (under ``enable_x64``) to 1e-10: the two take each
step's flows in another order (``x * (mu dt)`` against ``(mu x) dt``),
a few ULPs a step.  Its steady state reaches the planning LP with the
checks of ``tests/test_fluid_ctmc.py`` (Theorem 2; Theorem 4 for the
randomized router), at dt = 2e-2 instead of that test's 2e-3 so that the
CPU loop stays short: the Euler map's fixed point does not depend on dt,
and the port's steady state is held to the reference's at the same dt.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import fluid as ref_fluid
from repro.core import planning as ref_planning
from repro.core import types as ref_types
from repro_torch.core import fluid, planning, types

SPEC = [("decode_heavy", 300, 1000, 0.5, 0.1),
        ("prefill_heavy", 3000, 400, 0.5, 0.1)]


def _inst(mod, plan_mod):
    classes = [mod.WorkloadClass(nm, p, d, arrival_rate=lam, patience=th)
               for nm, p, d, lam, th in SPEC]
    prim, price = mod.ServicePrimitives(), mod.Pricing(0.1, 0.2)
    plan = plan_mod.solve_bundled_lp(
        classes, prim, price,
        sli=plan_mod.SLISpec(pin_zero_decode_queue=True))
    return classes, prim, price, plan


@pytest.mark.parametrize("randomized", [False, True],
                         ids=["solo_first", "randomized"])
def test_trajectory_matches_reference_float64(randomized):
    """5 s of dynamics from empty and from a loaded state (every queue and
    pool nonzero, so the buffer drains and the gate bind), recorded every
    step: every field within 1e-10 of the reference's."""
    loaded = {"qp": [3.0, 1.0], "x": [0.01, 0.3], "qdm": [0.5, 0.2],
              "qds": [1.0, 0.4], "ym": [5.0, 2.0], "ys": [6.0, 4.0]}
    for x0 in (None, loaded):
        args = dict(horizon=5.0, dt=1e-3, randomized_router=randomized,
                    x0=x0, record_stride=1)
        got = fluid.integrate_fluid(*_inst(types, planning), **args,
                                    dtype=torch.float64, device="cpu")
        with enable_x64():
            want = ref_fluid.integrate_fluid(*_inst(ref_types, ref_planning),
                                             **args)
        np.testing.assert_array_equal(got.t, want.t)
        for k in ("qp", "x", "qd", "ym", "ys", "revenue_rate"):
            a, b = getattr(got, k), np.asarray(getattr(want, k))
            assert a.dtype == np.float64 and a.shape == b.shape, k
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=k)


def test_core_and_final_state_agree():
    """integrate_fluid_core's last row and fluid_final_state are one
    state, and the core matches the reference's core in float64."""
    classes, prim, price, plan = _inst(types, planning)
    p = fluid.fluid_params(classes, prim, price, plan, dtype=torch.float64,
                           device="cpu")
    z = torch.zeros(2, dtype=torch.float64)
    out = fluid.integrate_fluid_core(p, (z,) * 6, 1e-3, n_steps=500,
                                     randomized=False)
    final, rev = fluid.fluid_final_state(p, (z,) * 6, 1e-3, n_steps=500,
                                         randomized=False)
    assert out[0].shape == (500, 2) and out[5].shape == (500,)
    torch.testing.assert_close(out[1][-1], final[1], rtol=0, atol=0)
    torch.testing.assert_close(out[5][-1], rev, rtol=0, atol=0)
    rclasses, rprim, rprice, rplan = _inst(ref_types, ref_planning)
    with enable_x64():
        rp = ref_fluid.fluid_params(rclasses, rprim, rprice, rplan)
        rz = jax.numpy.zeros(2)
        want = ref_fluid.integrate_fluid_core(rp, (rz,) * 6, 1e-3,
                                              n_steps=500, randomized=False)
        want = [np.asarray(w) for w in want]
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("randomized", [False, True],
                         ids=["solo_first", "randomized"])
def test_steady_state_reaches_the_lp(randomized):
    classes, prim, price, plan = _inst(types, planning)
    ss = fluid.fluid_steady_state(classes, prim, price, plan, horizon=300.0,
                                  dt=2e-2, randomized_router=randomized,
                                  device="cpu")
    if randomized:
        # Theorem 4: class-level decode occupancies converge to (y_m*, y_s*)
        np.testing.assert_allclose(ss["ym"], plan.ym, atol=1.5e-2)
        np.testing.assert_allclose(ss["ys"], plan.ys, atol=1.5e-2)
    else:
        # Theorem 2 (fluid version): prefill occupancy -> x*, revenue -> R*
        np.testing.assert_allclose(ss["x"], plan.x, atol=5e-3)
        assert ss["revenue_rate"] == pytest.approx(plan.revenue_rate,
                                                   rel=0.02)
        assert np.all(ss["qd"] < 5e-3)  # the decode buffer drains
        np.testing.assert_allclose(ss["qp"], plan.qp, atol=2e-2)
    # float32 (the default, as the reference runs): the reference's
    # steady state at the same dt, to float32 resolution
    want = ref_fluid.fluid_steady_state(*_inst(ref_types, ref_planning),
                                        horizon=300.0, dt=2e-2,
                                        randomized_router=randomized)
    for k in ("qp", "x", "qd", "ym", "ys"):
        assert ss[k].dtype == np.float32
        np.testing.assert_allclose(ss[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert ss["revenue_rate"] == pytest.approx(want["revenue_rate"],
                                               rel=1e-5)
