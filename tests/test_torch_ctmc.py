"""The port's aggregate-CTMC engines held to the JAX package.

``repro_torch.core.simulator.CTMCSimulator`` is a framework-free copy:
bitwise on the same ``SeedSequence``s.  ``repro_torch.core.ctmc_jax``
draws from Philox, not JAX's threefry, so it is held to ``ctmc_jax`` and
to ``CTMCSimulator`` statistically, within 2 CI half-widths (the
reference's own contract between those two, ``tests/test_ctmc_jax.py``),
on the same instance; its budget arithmetic is held bitwise.  Here the
batch runs the kernel's plain PyTorch version (CPU tensors); the card
holds the kernel to it (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import ctmc_jax as ref_ctmc
from repro.core import planning as ref_planning
from repro.core import policies as ref_policies
from repro.core import simulator as ref_simulator
from repro.core import types as ref_types
from repro_torch.compat import prng_key
from repro_torch.core import ctmc_jax, planning, policies, simulator, types
from repro_torch.kernels.ctmc_scan.ops import (MAX_CLASSES, ctmc_scan,
                                               pack_block, philox4x32,
                                               uniforms)
from repro_torch.telemetry.probes import CTMC_PROBE_KEYS, ProbeSpec

# the instance of tests/test_ctmc_jax.py (the EC.8.5 two-class mix)
SPEC = [("decode_heavy", 300, 1000, 0.5, 0.1),
        ("prefill_heavy", 3000, 400, 0.5, 0.1)]
F64 = torch.float64


def _inst(mod):
    classes = [mod.WorkloadClass(nm, p, d, arrival_rate=lam, patience=th)
               for nm, p, d, lam, th in SPEC]
    return classes, mod.ServicePrimitives(), mod.Pricing(0.1, 0.2)


def _policy(pol_mod, plan_mod, types_mod, name):
    classes, prim, price = _inst(types_mod)
    pin = plan_mod.solve_bundled_lp(
        classes, prim, price, sli=plan_mod.SLISpec(pin_zero_decode_queue=True))
    if name == "gate_and_route":
        return pol_mod.gate_and_route(pin)
    if name == "baseline_vllm":
        return pol_mod.baseline_vllm(pin)
    if name == "prioritize_and_route":
        return pol_mod.prioritize_and_route(
            plan_mod.solve_separate_lp(classes, prim, price))
    if name == "sli_aware":
        return pol_mod.sli_aware_policy(pin)
    if name == "sli_aware_general":  # randomized router, EC.7 pool weights
        return pol_mod.sli_aware_policy(pin, general=True)
    if name == "gate_and_route_separate":  # bench_optimality_gap's scheme
        sep = plan_mod.solve_separate_lp(classes, prim, price)
        return pol_mod.gate_and_route(
            sep, name="gate_and_route_separate").replace(charging="separate")
    raise ValueError(name)


def _port(name, **kw):
    classes, prim, price = _inst(types)
    pol = _policy(policies, planning, types, name)
    kw.setdefault("device", "cpu")
    return ctmc_jax.UniformizedCTMC(classes, prim, price, pol, **kw)


def _half_width(vals):
    return 1.96 * np.std(vals, ddof=1) / np.sqrt(len(vals))


def _close(a, b):
    """Means of two replication samples within 2 CI half-widths (the
    reference's test_ctmc_jax tolerance)."""
    a, b = np.asarray(a), np.asarray(b)
    return abs(a.mean() - b.mean()) <= 2.0 * (_half_width(a)
                                              + _half_width(b)) + 1e-9


# ------------------------------------------------------ the Python oracle
@pytest.mark.parametrize("name,telemetry", [
    ("gate_and_route", False), ("baseline_vllm", False),
    ("prioritize_and_route", False), ("sli_aware_general", False),
    ("gate_and_route_separate", True)])
def test_ctmc_simulator_bitwise(name, telemetry):
    """The copied CTMCSimulator reproduces the reference's every output,
    probes included, on the same spawned SeedSequences."""
    got, want = [], []
    for mod, pol_mod, plan_mod, tmod, out in (
            (simulator, policies, planning, types, got),
            (ref_simulator, ref_policies, ref_planning, ref_types, want)):
        classes, prim, price = _inst(tmod)
        pol = _policy(pol_mod, plan_mod, tmod, name)
        sim = mod.CTMCSimulator(classes, prim, price, pol, n=20,
                                telemetry=telemetry, record_every=2.0)
        out.extend(sim.run_batch(
            20.0, warmup=5.0, rngs=np.random.SeedSequence(3).spawn(2)))
    for g, w in zip(got, want):
        for f in ("t_end", "revenue", "revenue_rate_per_server", "n_events"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("completions", "arrivals", "abandons_p", "abandons_d",
                  "avg_x", "avg_ym", "avg_ys", "avg_qp", "avg_qd"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
        for k, v in w.trajectory.items():
            np.testing.assert_array_equal(g.trajectory[k], v, k)
        assert (g.telemetry is None) == (w.telemetry is None)
        for k, v in (w.telemetry or {}).items():
            np.testing.assert_array_equal(np.asarray(g.telemetry[k]),
                                          np.asarray(v), k)


# --------------------------------------------------- the bound and budget
@pytest.mark.parametrize("name", ["gate_and_route", "baseline_vllm",
                                  "sli_aware"])
@pytest.mark.parametrize("stepping", ["events", "ticks"])
def test_uniformization_bound_and_budget_bitwise(name, stepping):
    classes, prim, _ = _inst(types)
    rclasses, rprim, _ = _inst(ref_types)
    pol = _policy(policies, planning, types, name)
    rpol = _policy(ref_policies, ref_planning, ref_types, name)
    for n in (16, 50, 65536):
        got = ctmc_jax.uniformization_bound(classes, prim, pol, n)
        want = ref_ctmc.uniformization_bound(rclasses, rprim, rpol, n)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)
        for H in (40.0, 100.0, 300.0):
            sim = _port(name, n=n, horizon=H, warmup=10.0, stepping=stepping)
            rclasses, rprim, rprice = _inst(ref_types)
            ref = ref_ctmc.UniformizedCTMC(rclasses, rprim, rprice, rpol,
                                           n=n, horizon=H, warmup=10.0,
                                           stepping=stepping)
            assert (sim.n_steps, sim.Lambda, sim.M) == (ref.n_steps,
                                                         ref.Lambda, ref.M)
            assert (sim.gate_kind, sim.router_kind, sim.charging,
                    sim.has_pw) == (ref.gate_kind, ref.router_kind,
                                    ref.charging, ref.has_pw)


# ------------------------------------------------ statistical equivalence
@pytest.mark.parametrize("name", ["gate_and_route", "baseline_vllm"])
def test_statistical_equivalence_with_ctmc_jax_and_simulator(name):
    """tests/test_ctmc_jax.py::test_statistical_equivalence's instance
    (n=50, horizon 40, warmup 10, 12 replications): the port's revenue
    rate and occupancies lie within 2 CI half-widths of both the
    reference's ctmc_jax (float64, as the port runs here) and the Python
    CTMCSimulator; its budget covered the horizon and nothing clipped."""
    n, horizon, warmup, reps = 50, 40.0, 10.0, 12
    sim = _port(name, n=n, horizon=horizon, warmup=warmup, dtype=F64)
    raw = sim.run_batch_raw(list(range(reps)))
    got = sim.results_from_raw(raw)
    assert bool((raw["t"] == horizon).all())
    assert float(raw["clip_steps"].sum()) == 0.0

    classes, prim, price = _inst(ref_types)
    rpol = _policy(ref_policies, ref_planning, ref_types, name)
    with enable_x64():
        rsim = ref_ctmc.UniformizedCTMC(classes, prim, price, rpol, n=n,
                                        horizon=horizon, warmup=warmup)
        ref_jx = rsim.results_from_raw(rsim.run_batch_raw(list(range(reps))))
    ref_py = ref_simulator.CTMCSimulator(classes, prim, price, rpol,
                                         n=n).run_batch(
        horizon, warmup=warmup, rngs=np.random.SeedSequence(7).spawn(reps))

    for ref in (ref_jx, ref_py):
        assert _close([r.revenue_rate_per_server for r in got],
                      [r.revenue_rate_per_server for r in ref])
        for attr in ("avg_x", "avg_ym", "avg_ys"):
            a = np.array([getattr(r, attr) for r in got])
            b = np.array([getattr(r, attr) for r in ref])
            for i in range(len(SPEC)):
                tol = 2.0 * (_half_width(a[:, i]) + _half_width(b[:, i]))
                assert abs(a[:, i].mean() - b[:, i].mean()) <= tol + 1e-4


@pytest.mark.parametrize("name", ["gate_and_route_separate",
                                  "sli_aware_general"])
def test_separate_charging_and_pool_weights_match_the_simulator(name):
    """Separate charging (bench_optimality_gap's second scheme) and the
    randomized router with EC.7 pool weights, against the Python
    oracle's revenue rate and decode occupancies (2 CI half-widths)."""
    n, horizon, warmup, reps = 20, 30.0, 8.0, 10
    got = _port(name, n=n, horizon=horizon, warmup=warmup,
                dtype=F64).run_batch(list(range(reps)))
    classes, prim, price = _inst(ref_types)
    rpol = _policy(ref_policies, ref_planning, ref_types, name)
    ref = ref_simulator.CTMCSimulator(classes, prim, price, rpol,
                                      n=n).run_batch(
        horizon, warmup=warmup, rngs=np.random.SeedSequence(1).spawn(reps))
    assert all(r.t_end == horizon for r in got)
    assert _close([r.revenue_rate_per_server for r in got],
                  [r.revenue_rate_per_server for r in ref])
    for attr in ("avg_ym", "avg_ys"):
        a = np.array([getattr(r, attr).sum() for r in got])
        b = np.array([getattr(r, attr).sum() for r in ref])
        assert _close(a, b), attr


def test_ticks_mode_matches_events_mode():
    """The strict Lambda-clock stepping has the same law as the default
    (coarse check on the mean revenue rate), covers the horizon and
    never clips."""
    kw = dict(n=10, horizon=10.0, warmup=2.0, dtype=F64)
    ev = _port("gate_and_route", **kw)
    tk = _port("gate_and_route", stepping="ticks", **kw)
    assert tk.n_steps > ev.n_steps  # self-loops make the tick budget larger
    r_ev = [r.revenue_rate_per_server for r in ev.run_batch(range(8))]
    raw = tk.run_batch_raw(range(8))
    r_tk = [r.revenue_rate_per_server for r in tk.results_from_raw(raw)]
    assert _close(r_ev, r_tk)
    assert bool((raw["t"] == 10.0).all())
    assert float(raw["clip_steps"].sum()) == 0.0


# ------------------------------------------------------------ determinism
def test_determinism_same_seed_bitwise():
    """Same seeds give bitwise-equal carries (also one seed at a time and
    inside a multi-cell call); different seeds differ."""
    sim = _port("gate_and_route", n=10, horizon=5.0, warmup=1.0)
    a = sim.run_batch_raw([3, 4])
    b = sim.run_batch_raw([3, 4])
    single = [sim.run_raw(s) for s in (3, 4)]
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        for r in (0, 1):
            torch.testing.assert_close(a[k][r], single[r][k], rtol=0, atol=0)
    c = sim.run_batch_raw([3, 5])
    assert float(a["rev"][1]) != float(c["rev"][1])
    assert sim.run(3).revenue == float(a["rev"][0])
    # a cell of another size and scheme beside it changes nothing
    other = _port("gate_and_route_separate", n=20, horizon=5.0, warmup=1.0)
    cells = ctmc_jax.run_cells_raw([(sim, [3, 4]), (other, [9])])
    ref_other = other.run_batch_raw([9])
    for k in a:
        torch.testing.assert_close(cells[0][k], a[k], rtol=0, atol=0)
        torch.testing.assert_close(cells[1][k], ref_other[k], rtol=0, atol=0)


def test_conservation_laws():
    """Pathwise per-class flow conservation and the capacity invariants."""
    sim = _port("gate_and_route", n=20, horizon=20.0)
    raw = {k: v.numpy() for k, v in sim.run_raw(11).items()}
    in_system = (raw["qp"] + raw["x"] + raw["qdm"] + raw["qds"]
                 + raw["ym"] + raw["ys"])
    np.testing.assert_allclose(
        raw["arrivals"],
        raw["completions"] + raw["ab_p"] + raw["ab_d"] + in_system,
        atol=1e-5)
    B = types.ServicePrimitives().batch_cap
    assert raw["x"].sum() <= sim.M + 1e-5
    assert raw["ym"].sum() <= (B - 1) * sim.M + 1e-5
    assert raw["ys"].sum() <= B * (sim.n - sim.M) + 1e-5


def test_telemetry_shapes_and_invariance():
    """telemetry=True adds the reference's CTMC probe arrays, shaped as
    its carry (one leading replication axis); every other output is
    bitwise unchanged and the per-bin event counts sum to n_events."""
    kw = dict(n=10, horizon=10.0, warmup=2.0)
    off = _port("gate_and_route", **kw).run_batch_raw([0, 1])
    sim = _port("gate_and_route", telemetry=True, **kw)
    on = sim.run_batch_raw([0, 1])
    classes, prim, price = _inst(ref_types)
    rsim = ref_ctmc.UniformizedCTMC(
        classes, prim, price,
        _policy(ref_policies, ref_planning, ref_types, "gate_and_route"),
        telemetry=True, **kw)
    ref = rsim.run_batch_raw([0, 1])
    assert set(on) - set(off) == set(CTMC_PROBE_KEYS)
    assert set(on) == set(ref)
    for k in CTMC_PROBE_KEYS:
        assert tuple(on[k].shape) == tuple(np.asarray(ref[k]).shape), k
    for k in off:
        torch.testing.assert_close(on[k], off[k], rtol=0, atol=0)
    torch.testing.assert_close(on["tlm_ev"].sum(1), on["n_events"], rtol=0,
                               atol=0)
    rep = sim.telemetry_from_raw(on)
    assert rep["events"].sum() == float(on["n_events"].sum())
    assert rep["queue_depth"].shape == (ProbeSpec().n_bins, len(SPEC))


def test_float32_default_and_shard_map_raises():
    """float32 is the default dtype, as the reference runs without x64;
    the sharded placement (the sweep layer, ROADMAP A8) splits the batch
    over the CUDA cards and raises on a host without one unless it is
    given a device list, over which it equals the vmap batch."""
    sim = _port("baseline_vllm", n=10, horizon=5.0, warmup=1.0)
    raw = sim.run_batch_raw([0, 1])
    assert raw["t"].dtype == torch.float32 and bool((raw["t"] == 5.0).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.run_batch_raw([0], placement="shard_map")
    got = sim.run_batch_raw([0, 1], placement="shard_map",
                            shard={"devices": ["cpu"] * 2})
    for k in raw:
        assert torch.equal(got[k], raw[k]), k


# ------------------------------------------------------------ the generator
def _philox_np(ctr, key):
    """Philox4x32-10 written independently in numpy uint64 (full 64-bit
    products, no limbs)."""
    m32 = np.uint64(0xFFFFFFFF)
    c = [np.uint64(v) for v in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m32
            k1 = (k1 + np.uint64(0xBB67AE85)) & m32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m32]
    return [int(v) for v in c]


def test_philox_matches_numpy_and_known_answers():
    # Random123's known-answer vectors for philox4x32-10 (ctr, key, out)
    kat = [([0, 0, 0, 0], [0, 0],
            [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]),
           ([0xffffffff] * 4, [0xffffffff] * 2,
            [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]),
           ([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
            [0xa4093822, 0x299f31d0],
            [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1])]
    for ctr, key, out in kat:
        assert philox4x32(torch.tensor(ctr), torch.tensor(key)).tolist() \
            == out
        assert _philox_np(ctr, key) == out
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2 ** 32, size=(64, 4))
    key = rng.integers(0, 2 ** 32, size=(64, 2))
    got = philox4x32(torch.from_numpy(ctr), torch.from_numpy(key)).numpy()
    for r in range(64):
        assert got[r].tolist() == _philox_np(ctr[r], key[r])
    # the step's uniforms: exact conversions, in [0, 1)
    keys = torch.stack([prng_key(5), prng_key(2 ** 40 + 7)])
    for dt, bits in ((torch.float32, 24), (F64, 53)):
        u = uniforms(keys, 1000, 16, dt)
        assert u.shape == (2, 16, 4) and u.dtype == dt
        assert bool(((u >= 0) & (u < 1)).all())
        scaled = u.double() * 2.0 ** bits
        assert bool((scaled == scaled.round()).all())
    words = philox4x32(
        torch.tensor([1000, 0, 0, 0]), keys[0])
    u32 = uniforms(keys[:1], 1000, 1, torch.float32)[0, 0]
    assert u32.tolist() == [(w >> 8) * 2.0 ** -24 for w in words.tolist()]


def test_prng_key_words():
    assert prng_key(7).tolist() == [7, 0]
    assert prng_key(2 ** 40 + 3).tolist() == [3, 2 ** 8]
    assert prng_key(-1).tolist() == [2 ** 32 - 1, 2 ** 32 - 1]


def test_wrapper_checks_its_block():
    """The wrapper runs the plain version for CPU tensors at any class
    count (the card's kernel stops at MAX_CLASSES), and refuses a
    malformed block."""
    I = MAX_CLASSES + 1
    classes = [types.WorkloadClass(f"c{i}", 300 + 500 * i, 1000 - 100 * i,
                                   0.2, 0.1) for i in range(I)]
    prim, price = types.ServicePrimitives(), types.Pricing(0.1, 0.2)
    sim = ctmc_jax.UniformizedCTMC(
        classes, prim, price,
        policies.gate_and_route(planning.solve_bundled_lp(classes, prim,
                                                          price)),
        n=8, horizon=3.0, device="cpu")
    fp, ip = pack_block(sim.params, sim._static,
                        torch.stack([prng_key(0), prng_key(1)]))
    out = ctmc_scan(fp, ip, n_classes=I)
    assert out["qp"].shape == (2, I) and bool((out["t"] == 3.0).all())
    with pytest.raises(ValueError, match="fparams"):
        ctmc_scan(fp, ip, n_classes=2)
    with pytest.raises(TypeError, match="dtype"):
        ctmc_scan(fp.to(torch.bfloat16), ip, n_classes=I)
