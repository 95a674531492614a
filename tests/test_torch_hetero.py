"""The port's fleet layer (``repro_torch.core.hetero``) held to the
reference's ``repro.core.hetero`` on the CPU.

The registry, the roofline-resolved class primitives, ``server_params``
and ``blind_primitives`` are framework-free: bit for bit.  ``plan_fleet``
runs the batched interior point: within 1e-6 of the reference's at
``bench_heterogeneity.py``'s fleets (the reference's float64 IPM), and a
one-class ``paper-a100`` fleet at ``xfer_scale=0`` equals the port's own
``solve_plan_jax`` exactly (the benchmark's ``degenerate_exact``).
"""

import numpy as np
import pytest

from repro.core import hetero as RH
from repro.core.types import Pricing as RPricing
from repro.core.types import WorkloadClass as RWC
from repro_torch.core import hetero as TH
from repro_torch.core.planning_batch import solve_plan_jax
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass

# bench_heterogeneity.py's WORKLOAD at LAMBDA_PER_SERVER, its pricing and
# its FULL_FLEETS (instance -> (fleet rows, xfer scales))
WORKLOAD = (("decode-heavy", 300, 1000, 24.0, 0.1),
            ("prefill-heavy", 3000, 400, 24.0, 0.1))
FULL_FLEETS = {
    "mixed_a100_h100": ((("a100-cal", 3), ("h100-cal", 3)),
                        (0.0, 1.0, 4.0)),
    "mixed_three_class": ((("a100-cal", 2), ("h100-cal", 2),
                           ("l4-cal", 2)), (1.0,)),
}
# the committed artifact's R* (artifacts/bench/heterogeneity.json)
ARTIFACT_R = {("mixed_a100_h100", 0.0): 9604.37,
              ("mixed_a100_h100", 1.0): 9560.404,
              ("mixed_a100_h100", 4.0): 7457.062,
              ("mixed_three_class", 1.0): 8208.814}


def _fleets():
    for name, (rows, xss) in FULL_FLEETS.items():
        for xs in xss:
            yield name, rows, xs


def test_registry_is_the_reference():
    assert TH.list_server_classes() == RH.list_server_classes()
    for name in RH.list_server_classes():
        a, b = RH.get_server_class(name), TH.get_server_class(name)
        assert (a.name, a.arch, a.speed, a.link_gbps, a.kv_bytes_per_token,
                a.b_s) == (b.name, b.arch, b.speed, b.link_gbps,
                           b.kv_bytes_per_token, b.b_s)
        assert a.kv_sec_per_token == b.kv_sec_per_token
    with pytest.raises(KeyError):
        TH.get_server_class("tpu-v9")
    with pytest.raises(ValueError):
        TH.register_server_class(TH.get_server_class("paper-a100"))


@pytest.mark.parametrize("kw", [dict(), dict(prim=ServicePrimitives(),
                                             arch="qwen2-0.5b"),
                                dict(arch="qwen2-0.5b", speed=0.0),
                                dict(arch="qwen2-0.5b",
                                     kv_bytes_per_token=-1.0)])
def test_server_class_validation(kw):
    with pytest.raises(ValueError):
        TH.ServerClass(name="x", **kw)


@pytest.mark.parametrize("name", ["paper-a100", "a100-cal", "h100-cal",
                                  "l4-cal"])
def test_resolve_class_primitives_bitwise(name):
    a_prim, a_bs = RH.resolve_class_primitives(RH.get_server_class(name))
    b_prim, b_bs = TH.resolve_class_primitives(TH.get_server_class(name))
    assert a_bs == b_bs
    for f in ("alpha", "beta", "gamma", "batch_cap", "chunk", "tau_solo"):
        assert getattr(a_prim, f) == getattr(b_prim, f), f


@pytest.mark.parametrize("name,rows,xs", list(_fleets()))
def test_server_params_and_blind_primitives_bitwise(name, rows, xs):
    a = RH.FleetSpec.of(list(rows), xfer_scale=xs)
    b = TH.FleetSpec.of(list(rows), xfer_scale=xs)
    assert (a.n, a.n_classes) == (b.n, b.n_classes)
    np.testing.assert_array_equal(a.weights, b.weights)
    pa, pb = a.server_params(), b.server_params()
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].dtype == pb[k].dtype
        np.testing.assert_array_equal(pa[k], pb[k])
    (ap, abs_, akv), (bp, bbs, bkv) = (RH.blind_primitives(a),
                                       TH.blind_primitives(b))
    assert (abs_, akv) == (bbs, bkv)
    for f in ("alpha", "beta", "gamma", "tau_solo"):
        assert getattr(ap, f) == getattr(bp, f)
    for (w1, p1, k1), (w2, p2, k2) in zip(a.planner_fleet(),
                                          b.planner_fleet()):
        assert (w1, k1, p1.alpha, p1.beta, p1.gamma) == (
            w2, k2, p2.alpha, p2.beta, p2.gamma)


def test_fleet_spec_validation():
    with pytest.raises(ValueError):
        TH.FleetSpec((), ())
    with pytest.raises(ValueError):
        TH.FleetSpec.of([("paper-a100", 0)])
    with pytest.raises(ValueError):
        TH.FleetSpec.of([("paper-a100", 2)], xfer_scale=-1.0)


@pytest.mark.parametrize("name,rows,xs", list(_fleets()))
def test_plan_fleet_at_the_benchmark_fleets(name, rows, xs):
    from repro.compat import enable_x64

    cl = [WorkloadClass(*w) for w in WORKLOAD]
    got = TH.plan_fleet(cl, TH.FleetSpec.of(list(rows), xfer_scale=xs),
                        Pricing(0.1, 0.2), device="cpu")
    with enable_x64():
        want = RH.plan_fleet([RWC(*w) for w in WORKLOAD],
                             RH.FleetSpec.of(list(rows), xfer_scale=xs),
                             RPricing(0.1, 0.2))
    assert float(got.revenue_rate) == pytest.approx(
        float(want.revenue_rate), rel=1e-6)
    assert round(float(got.revenue_rate), 3) == ARTIFACT_R[(name, xs)]
    np.testing.assert_allclose(got.split_probs(), want.split_probs(),
                               atol=1e-6)
    for c, (pa, pb) in enumerate(zip(TH.class_aware_policies(got),
                                     RH.class_aware_policies(want))):
        assert pa.name == pb.name == f"gate_and_route_pool{c}"
        np.testing.assert_allclose(pa.plan.x, pb.plan.x, atol=1e-6)


def test_one_class_fleet_is_the_homogeneous_plan_exactly():
    """bench_heterogeneity's control: paper-a100 x 16, no transfer cost,
    on OVERLOADED_MIX -- R* and x equal solve_plan_jax's exactly."""
    cl = [WorkloadClass("decode-heavy", 300, 1000, 1.0, 0.1),
          WorkloadClass("prefill-heavy", 3000, 400, 1.0, 0.1)]
    h = TH.plan_fleet(cl, TH.FleetSpec.of([("paper-a100", 16)],
                                          xfer_scale=0.0), Pricing(),
                      device="cpu")
    hom = solve_plan_jax(cl, ServicePrimitives(), Pricing(), device="cpu")
    assert float(h.revenue_rate) == float(hom.revenue_rate)
    np.testing.assert_array_equal(h.pool_plan(0).x, hom.x)
    assert float(h.revenue_rate) == pytest.approx(570.6791985698203,
                                                  rel=1e-12)
