"""The port's sweep layer (``repro_torch.sweep``) held to the reference's
``repro.sweep`` on the CPU.

Schema, seeds and the host evaluators (``ctmc``, ``lp``, ``engine``)
are framework-free: held bit for bit.  The batched evaluators: ``lp_jax``
within 1e-6 of the reference's (under ``enable_x64``, as its float64
IPM runs); the fluid grid in float64 within 1e-10 of the reference's
under x64; ``ctmc_jax`` within 2 CI half-widths (Philox, not threefry);
``engine_jax`` with the deterministic routers within 1e-5 in times and
revenue, its discrete metrics exactly.
"""

import copy
import json
import math

import numpy as np
import pytest
import torch

import repro.sweep as R
import repro_torch.sweep as T
from repro.compat import enable_x64
from repro.sweep.run import default_mix as ref_mix
from repro_torch.sweep.run import default_mix as port_mix


def _pair(evaluator, mixes=None, **kw):
    """The same spec for both packages (built from one JSON dict)."""
    ref = R.SweepSpec(name="t", evaluator=evaluator,
                      mixes=mixes or (ref_mix(),), **kw)
    return ref, T.SweepSpec.from_dict(json.loads(json.dumps(ref.to_dict())))


def _run_both(evaluator, **kw):
    ref, port = _pair(evaluator, **kw)
    return R.run_sweep(ref), T.run_sweep(port, device="cpu")


# -- schema ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(evaluator="ctmc", policies=("gate_and_route", "FG-SP"),
         n_servers=(10, 20), n_seeds=3, seed=5),
    dict(evaluator="engine_jax", policies=("vllm",), n_servers=(8,),
         horizon=300.0, extra={"engine_jax": {"fastforward": True},
                               "placement": "shard_map"}),
    dict(evaluator="lp", policies=("lp", "lp_sli"), n_servers=(1,),
         extra={"crn_policies": True, "ctmc_jax": {"x64": True}}),
])
def test_spec_json_and_sha256_are_the_reference(kw):
    ref = R.SweepSpec(name="s", mixes=(ref_mix(), R.MixSpec(
        name="sc", scenario="rate_shift", trace={"horizon": 60.0})), **kw)
    port = T.SweepSpec.from_dict(ref.to_dict())
    assert port.to_dict() == ref.to_dict()
    assert T.SweepSpec.from_dict(port.to_dict()) == port
    ref_res = R.SweepResult(spec=ref, cells=[])
    # the reference's runner hashes exactly this way (runner.py:92-99)
    import hashlib
    want = hashlib.sha256(json.dumps(ref.to_dict(), sort_keys=True,
                                     default=float).encode()).hexdigest()
    assert T.spec_sha256(port) == want
    assert (T.SweepResult(spec=port, cells=[]).fingerprint()
            == ref_res.fingerprint())


def test_run_sweep_records_the_reference_spec_hash():
    ref, port = _run_both("lp", policies=("lp",), n_servers=(1,))
    assert (port.meta["manifest"]["extra"]["spec_sha256"]
            == ref.meta["manifest"]["extra"]["spec_sha256"])
    assert port.meta["manifest"]["device_name"] is None


@pytest.mark.parametrize("coords", [(0, 0, 0, 0), (1, 2, 3, 4),
                                    (0, 5, 0, 31)])
def test_cell_seeds_are_the_reference(coords):
    ref, port = _pair("ctmc", seed=11)
    a = R.cell_seed_sequence(ref, *coords)
    b = T.cell_seed_sequence(port, *coords)
    assert a.entropy == b.entropy
    np.testing.assert_array_equal(a.generate_state(4), b.generate_state(4))
    from repro.sweep.spec import cell_int_seed as ri
    from repro_torch.sweep.spec import cell_int_seed as ti
    assert ri(a) == ti(b)


def _corruptions(payload):
    def drop(k):
        p = copy.deepcopy(payload)
        del p[k]
        return p

    def edit(fn):
        p = copy.deepcopy(payload)
        fn(p)
        return p

    yield drop("cells")
    yield edit(lambda p: p.__setitem__("schema_version", 2))
    yield edit(lambda p: p["spec"].__setitem__("evaluator", "warp"))
    yield edit(lambda p: p["spec"].__setitem__("policies", []))
    yield edit(lambda p: p["cells"][0].__setitem__("mix", "nope"))
    yield edit(lambda p: p["cells"][0].__setitem__("policy", "nope"))
    yield edit(lambda p: p["cells"][0].__setitem__("metrics", {}))
    yield edit(lambda p: p["cells"][0]["metrics"].__setitem__("x", True))
    yield edit(lambda p: p["spec"]["mixes"][0].pop("name"))


def test_schema_rejections_match_the_reference(tmp_path):
    _, port = _run_both("lp", policies=("lp",), n_servers=(1,))
    payload = port.to_payload()
    path = port.save(tmp_path / "a.json")
    back = T.SweepResult.load(path)
    assert [c.to_dict() for c in back.cells] == payload["cells"]
    for bad in _corruptions(payload):
        with pytest.raises(R.SweepSchemaError) as e_ref:
            R.validate_payload(bad)
        with pytest.raises(T.SweepSchemaError) as e_port:
            T.validate_payload(bad)
        assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(T.SweepSchemaError):
        T.SweepSpec(evaluator="warp")
    with pytest.raises(T.SweepSchemaError):
        T.SweepSpec(n_seeds=0)


def test_non_finite_metrics_serialize_as_null(tmp_path):
    res = T.SweepResult(spec=T.SweepSpec(), cells=[T.CellResult(
        "default", "gate_and_route", 50, 0, {"a": float("nan"), "b": 1.0})])
    p = res.save(tmp_path / "n.json")
    assert json.loads(p.read_text())["cells"][0]["metrics"]["a"] is None
    assert math.isnan(T.SweepResult.load(p).cells[0].metrics["a"])


def test_evaluator_registry():
    for name in R.spec.EVALUATORS:
        ev = T.get_evaluator(name)
        assert ev.name == name
        assert ev.deterministic == R.get_evaluator(name).deterministic
        assert (ev.prepare is None) == (R.get_evaluator(name).prepare
                                        is None)
    with pytest.raises(T.SweepSchemaError, match="no evaluator registered"):
        T.get_evaluator("warp")


def test_run_sweep_needs_a_card_unless_cpu_is_asked_for():
    _, port = _pair("lp", policies=("lp",), n_servers=(1,))
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_sweep(port)
    with pytest.raises(ValueError, match="placement"):
        T.run_sweep(T.SweepSpec.from_dict(dict(
            port.to_dict(), extra={"placement": "warp"})), device="cpu")


@pytest.mark.parametrize("token", ["gate_and_route", "sli_aware", "FG-SP",
                                   "vllm", "sarathi",
                                   "distserve_mix_solo:frac=0.3",
                                   "prioritize_and_route",
                                   "gate_and_route_separate"])
def test_policy_tokens_resolve_as_the_reference(token):
    from repro.sweep.evaluators import MixContext as RC
    from repro.sweep.evaluators import resolve_policy as rr
    from repro_torch.sweep.evaluators import MixContext as TC
    from repro_torch.sweep.evaluators import resolve_policy as tr

    ref, port = _pair("ctmc")
    a = rr(token, RC(ref_mix(), ref), 10)
    b = tr(token, TC(port_mix(), port, device="cpu"), 10)
    assert (a.name, a.router, a.charging, a.partition) == (
        b.name, b.router, b.charging, b.partition)
    assert a.mixed_target(10) == b.mixed_target(10)
    np.testing.assert_array_equal(a.plan.x, b.plan.x)


# -- host evaluators: bit for bit -------------------------------------------


def test_ctmc_cells_bitwise():
    ref, port = _run_both("ctmc", policies=("gate_and_route", "sli_aware"),
                          n_servers=(6,), n_seeds=2, horizon=8.0,
                          warmup=2.0, extra={"crn_policies": True})
    assert [c.to_dict() for c in port.cells] == [c.to_dict()
                                                for c in ref.cells]


def test_lp_cells_bitwise():
    mixes = (ref_mix(), R.MixSpec(name="b8", classes=ref_mix().classes,
                                  prim={"batch_cap": 8},
                                  pricing={"c_p": 0.3, "c_d": 0.1}))
    ref, port = _run_both("lp", mixes=mixes,
                          policies=("lp", "lp_sli", "lp_separate"),
                          n_servers=(1,), n_seeds=2)
    assert [c.to_dict() for c in port.cells] == [c.to_dict()
                                                for c in ref.cells]


def test_engine_cells_bitwise():
    mix = R.MixSpec(name="tr", trace=dict(horizon=6.0, seed=3,
                                          compression=0.1))
    ref, port = _run_both("engine", mixes=(mix,),
                          policies=("gate_and_route", "vllm"),
                          n_servers=(4,), n_seeds=2, horizon=6.0)
    assert [c.to_dict() for c in port.cells] == [c.to_dict()
                                                for c in ref.cells]


# -- batched evaluators -------------------------------------------------------


def test_lp_jax_cells_within_1e6():
    mixes = (ref_mix(), R.MixSpec(name="b4", classes=ref_mix().classes,
                                  prim={"batch_cap": 4}))
    with enable_x64():
        ref, port = _run_both("lp_jax", mixes=mixes,
                              policies=("lp", "lp_sli", "lp_separate"),
                              n_servers=(1,))
    for a, b in zip(ref.cells, port.cells):
        assert b.metrics["lp_converged"] == a.metrics["lp_converged"] == 1.0
        for k, v in a.metrics.items():
            if k.startswith("lp_"):
                continue
            assert b.metrics[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    # and the same plans as the port's simplex
    _, simplex = _run_both("lp", mixes=mixes,
                           policies=("lp", "lp_sli", "lp_separate"),
                           n_servers=(1,))
    for a, b in zip(simplex.cells, port.cells):
        assert (a.mix, a.policy) == (b.mix, b.policy)
        assert b.metrics["revenue"] == pytest.approx(a.metrics["revenue"],
                                                     rel=1e-6)


def _fluid_params_both(dtype):
    from repro.core.fluid import fluid_params as rfp
    from repro_torch.core.fluid import fluid_params as tfp
    from repro.sweep.evaluators import MixContext as RC
    from repro_torch.sweep.evaluators import MixContext as TC

    ref, port = _pair("fluid")
    out = []
    for scale, randomized in ((1.0, False), (1.3, False), (0.7, True),
                              (1.0, True)):
        m = R.MixSpec(name=f"m{scale}", classes=tuple(
            dict(c, arrival_rate=c["arrival_rate"] * scale)
            for c in ref_mix().classes))
        rc = RC(m, ref)
        tc = TC(T.MixSpec.from_dict(m.to_dict()), port, device="cpu")
        kind = "sli" if randomized else "base"
        out.append((rfp(rc.classes, rc.prim, rc.pricing, rc.plan(kind),
                        randomized_router=randomized),
                    tfp(tc.classes, tc.prim, tc.pricing, tc.plan(kind),
                        randomized_router=randomized, dtype=dtype,
                        device="cpu"), randomized))
    return out


@pytest.mark.parametrize("randomized", [False, True])
def test_integrate_fluid_batch_float64_within_1e10(randomized):
    from repro.sweep.fluid_batch import integrate_fluid_batch as rib
    from repro_torch.sweep.fluid_batch import integrate_fluid_batch as tib

    with enable_x64():
        group = [g for g in _fluid_params_both(torch.float64)
                 if g[2] == randomized]
        (rs, rrev) = rib([g[0] for g in group], 1e-2, 600, randomized)
        rs = [np.asarray(v) for v in rs]
        rrev = np.asarray(rrev)
    ts, trev = tib([g[1] for g in group], 1e-2, 600, randomized)
    for a, b in zip(rs, ts):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(trev.numpy(), rrev, rtol=1e-10)
    # the batch equals each instance integrated alone
    for k, g in enumerate(group):
        s1, r1 = tib([g[1]], 1e-2, 600, randomized)
        for a, b in zip(ts, s1):
            assert torch.equal(a[k], b[0])
        assert torch.equal(trev[k], r1[0])


def test_fluid_cells_match_the_reference():
    """The fluid evaluator in float32, as the reference without x64:
    revenue within 1e-5 relative, plan errors within 1e-5."""
    ref, port = _run_both("fluid", policies=("gate_and_route", "sli_aware"),
                          n_servers=(1, 4), horizon=10.0,
                          extra={"dt": 1e-2})
    assert len(port.cells) == len(ref.cells) == 4
    for a, b in zip(ref.cells, port.cells):
        assert b.metrics.keys() == a.metrics.keys()
        for k, v in a.metrics.items():
            assert b.metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k


def test_graphed_fluid_loop_bookkeeping_equals_the_eager_loop(monkeypatch):
    """The card's graph path (runs of K steps replayed between record
    points, each remainder eager) with the graph stood in for by K eager
    steps on the CPU: the same rows and final state as the eager loop."""
    from repro_torch.core import fluid as F
    from repro_torch.core.planning import solve_bundled_lp
    from repro_torch.core.types import Pricing, ServicePrimitives

    replays = []

    class FakeGraph:
        def __init__(self, args, buf):
            self.args, self.buf = args, buf

        def replay(self):
            replays.append(1)
            x = self.buf
            p, kdt, adt, rnd, k = self.args
            for _ in range(k):
                x = F._fluid_step(p, x, kdt, adt, rnd)
            self.buf.copy_(x)

    def fake_capture(params, S, kdt, adt, randomized, k):
        buf = S.clone()
        return FakeGraph((params, kdt, adt, randomized, k), buf), buf

    monkeypatch.setattr(F, "GRAPH_STEPS", 16)
    monkeypatch.setattr(F, "_capture", fake_capture)
    classes = T.evaluators.MixContext(port_mix(), T.SweepSpec(),
                                      device="cpu").classes
    plan = solve_bundled_lp(classes, ServicePrimitives(), Pricing())
    p = F.fluid_params(classes, ServicePrimitives(), Pricing(), plan,
                       device="cpu")
    z = torch.zeros_like(p["lam"])
    for n, record in ((200, ()), (200, tuple(range(0, 200, 40))),
                      (190, (3, 50, 51, 189)), (10, (2,))):
        eager = F._integrate(p, (z,) * 6, 2e-3, n, False, record,
                             graphed=False)
        replays.clear()
        graph = F._integrate(p, (z,) * 6, 2e-3, n, False, record,
                             graphed=True)
        assert replays  # every case has a run of K steps or more
        for a, b in zip(eager[1], graph[1]):
            assert torch.equal(a, b)
        if record:
            for a, b in zip(eager[0], graph[0]):
                assert torch.equal(a, b)


def test_ctmc_jax_cells_within_two_ci_half_widths():
    """Philox is not threefry: the uniformized CTMC agrees with the
    reference's in distribution.  Per policy, the mean revenue rate over
    24 seeds within 2 combined CI half-widths; the engine diagnostics
    (t_end at the horizon, no clipped step) exactly."""
    kw = dict(policies=("gate_and_route", "sli_aware"), n_servers=(10,),
              n_seeds=24, horizon=20.0, warmup=5.0,
              extra={"crn_policies": True, "ctmc_jax": {"x64": True}})
    ref, port = _run_both("ctmc_jax", **kw)
    for pol in kw["policies"]:
        a = ref.metric("revenue_rate", policy=pol)
        b = port.metric("revenue_rate", policy=pol)
        half = 1.96 * math.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 2 * half, (pol, a.mean(),
                                                      b.mean(), half)
        assert all(c.metrics["t_end"] == 20.0
                   for c in port.select(policy=pol))
        assert all(c.metrics["clip_steps"] == 0
                   for c in port.select(policy=pol))
        assert (port.select(policy=pol)[0].metrics.keys()
                == ref.select(policy=pol)[0].metrics.keys())


ENGINE_DISCRETE = ("completions", "arrivals", "abandons", "n_iters",
                   "n_events", "n_steps", "n_dropped", "budget_exhausted",
                   "completion_rate")


def test_engine_jax_cells_match_the_reference():
    """Deterministic routers on a scenario mix: discrete metrics exactly,
    times and revenue within 1e-5 relative."""
    mix = R.MixSpec(name="rate_shift", scenario="rate_shift",
                    trace={"horizon": 12.0, "rate_scale": 0.2})
    ref, port = _run_both("engine_jax", mixes=(mix,),
                          policies=("gate_and_route", "vllm",
                                    "distserve_mix_solo:k=2"),
                          n_servers=(4,), n_seeds=2, horizon=12.0,
                          extra={"engine_jax": {"fastforward": False}})
    for a, b in zip(ref.cells, port.cells):
        assert b.metrics.keys() == a.metrics.keys()
        for k, v in a.metrics.items():
            if k in ENGINE_DISCRETE:
                assert b.metrics[k] == v, k
            elif math.isnan(v):
                assert math.isnan(b.metrics[k]), k
            else:
                assert b.metrics[k] == pytest.approx(v, rel=1e-5), k
        assert b.metrics["budget_exhausted"] == 0.0


def test_batch_plans_prewarm_matches_the_simplex():
    ref, port = _pair("ctmc", policies=("gate_and_route", "sli_aware"),
                      n_servers=(6,), n_seeds=1, horizon=4.0, warmup=1.0)
    from repro_torch.sweep.evaluators import MixContext, prewarm_plans

    ctx = MixContext(port_mix(), port, device="cpu")
    assert prewarm_plans([ctx], port.policies) == 2
    simplex = MixContext(port_mix(), port, device="cpu")
    for kind in ("base", "sli"):
        assert ctx.plan(kind).revenue_rate == pytest.approx(
            simplex.plan(kind).revenue_rate, rel=1e-6)


# -- the CLI -------------------------------------------------------------------


def test_cli_smoke_writes_artifact_and_sidecar_manifest(tmp_path, capsys):
    from repro_torch.sweep.run import main
    from repro_torch.telemetry.manifest import read_records, validate_record

    out = tmp_path / "smoke.json"
    assert main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    res = T.SweepResult.load(out)
    assert len(res.cells) == 1 and res.spec.evaluator == "ctmc"
    (rec,) = read_records(tmp_path / "smoke.runs.jsonl")
    assert validate_record(rec) == [] and rec["kind"] == "sweep"
    assert "wrote" in capsys.readouterr().out
    # the same grid through the reference's CLI: the same cells
    from repro.sweep.run import main as ref_main
    ref_out = tmp_path / "ref.json"
    assert ref_main(["--smoke", "--out", str(ref_out)]) == 0
    assert (json.loads(out.read_text())["cells"]
            == json.loads(ref_out.read_text())["cells"])


def test_cli_scenarios_and_extra(tmp_path):
    from repro_torch.sweep.run import main

    out = tmp_path / "e.json"
    assert main(["--evaluator", "engine_jax", "--scenarios", "azure_2023",
                 "--policies", "vllm", "--ns", "4", "--n-seeds", "1",
                 "--horizon", "10", "--device", "cpu", "--extra",
                 '{"engine_jax": {"fastforward": true}}',
                 "--out", str(out)]) == 0
    res = T.SweepResult.load(out)
    assert res.spec.extra == {"engine_jax": {"fastforward": True}}
    assert res.spec.mixes[0].trace == {"horizon": 10.0}
    assert res.cells[0].metrics["budget_exhausted"] == 0.0
    with pytest.raises(SystemExit):
        main(["--scenarios", "azure_2023", "--device", "cpu"])
