"""The port's batched trace-replay engine (``repro_torch.serving.
engine_jax``) against the reference's ``ClusterEngineJAX``, on the CPU.

The parity instance is ``tests/test_engine_diff.py::_mk`` cut to horizon
3 at compression 0.08, with batch cap 2 (40 requests, 1400-1950 events a
replay, where the reference's horizon 25 at compression 0.2 gives about
3300): the port's CPU route runs its step eagerly, about a millisecond a
step.  The trace is dense enough that in every deterministic case some
class queue holds at least two jobs at once, which the parity test
asserts, so the gates' refusals and the queues' order are exercised.
Both engines get the same padded trace, built by each package's own
(bitwise identical) trace and planning modules.

Tolerances: discrete outcomes -- lifecycle codes (hence arrivals and
completions), abandons, event and iteration counts, cursors, slots --
are equal; times and revenue (float32 in both) agree within 1e-5
relative, the reference's own stream-vs-batch tolerance.  The randomized
router draws other random numbers than JAX's, so it is held within two
CI half-widths across replications.
"""

import dataclasses
import importlib

import jax  # noqa: F401  (JAX and PyTorch share the process)
import numpy as np
import pytest
import torch

N = 8
HORIZON = 3.0
COMPRESSION = 0.08
BATCH_CAP = 2
PAD = 128
RTOL = 1e-5
# raw carry arrays held within RTOL; every other array is held exactly
FLOATS = ("t_first", "t_last", "rev", "t", "t_next", "pf_left", "t_buf",
          "tlm_busy_srv", "tlm_busy_bin")

_CACHE = {}


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _mk(pkg, seed=42, compression=COMPRESSION, horizon=HORIZON,
        patience=None, batch_cap=BATCH_CAP):
    """_mk through one package: (padded tensors, classes, plan, prim)."""
    key = (pkg, seed, compression, horizon, patience, batch_cap)
    if key not in _CACHE:
        tr, ty, pl = _m(pkg, "data.traces"), _m(pkg, "core.types"), \
            _m(pkg, "core.planning")
        trace = tr.synth_azure_trace(tr.TraceConfig(
            horizon=horizon, base_rate=2.0, compression=compression,
            seed=seed))
        if patience is not None:  # per-class deadlines: expiry runs
            trace = [dataclasses.replace(r, patience=patience[r.cls])
                     for r in trace]
        classes = [ty.WorkloadClass(nm, m[0], m[1], m[2] / N, patience=3e-4)
                   for nm, m in zip(("code", "conv"),
                                    tr.trace_class_means(trace, 2))]
        prim = ty.ServicePrimitives(batch_cap=batch_cap)
        plan = pl.solve_bundled_lp(classes, prim, ty.Pricing(0.1, 0.2),
                                   sli=pl.SLISpec(pin_zero_decode_queue=True))
        _CACHE[key] = (tr.tensorize_trace(trace, pad_to=PAD), classes, plan,
                       prim)
    return _CACHE[key]


def _policy(pkg, name, plan):
    p = _m(pkg, "core.policies")
    return {"gate_and_route": p.gate_and_route,
            "prioritize": p.prioritize_and_route,
            "vllm": p.baseline_vllm, "sarathi": p.baseline_sarathi,
            "distserve": lambda pl: p.baseline_distserve(pl, 3),
            "distserve_po": lambda pl: p.baseline_distserve(
                pl, 3, variant="prefill_solo"),
            "fcfs_sp": lambda pl: p.ablation_policy(pl, "FG-SP"),
            "gi_wsp": lambda pl: p.ablation_policy(pl, "GI-WSP"),
            "sli": p.sli_aware_policy,
            "sli_general": lambda pl: p.sli_aware_policy(pl, general=True),
            }[name](plan)


class _Fleet:
    """A duck-typed heterogeneous fleet: ``n`` and per-server surfaces."""

    def __init__(self, n):
        self.n = n

    def server_params(self, prim):
        s = np.where(np.arange(self.n) % 2 == 0, 1.0, 0.6)
        return {"alpha": prim.alpha * s, "beta": prim.beta * s,
                "tau_solo": prim.tau_solo * s,
                "b_s": np.full(self.n, 1.08e-7) * s,
                "kv_xfer": np.where(np.arange(self.n) < 3, 2e-6, 0.0)}


def _table(pkg):
    return _m(pkg, "calibration.models").TableModel(
        mix_x=(1.0, 64.0, 256.0), mix_y=(0.018, 0.021, 0.033),
        solo_x=(0.0, 2e4, 2e5), solo_y=(0.009, 0.0105, 0.02))


def _engine(pkg, name, *, cfg_kw=None, policy_kw=None, mk_kw=None, **kw):
    tt, classes, plan, prim = _mk(pkg, **(mk_kw or {}))
    cfg_kw = dict(cfg_kw or {})
    if cfg_kw.pop("table", False):
        cfg_kw["iter_model"] = _table(pkg)
    pol = _policy(pkg, name, plan)
    if policy_kw:
        pol = dataclasses.replace(pol, **policy_kw)
    sim, ty = _m(pkg, "serving.engine_sim"), _m(pkg, "core.types")
    if pkg == "repro_torch":
        tt = _m(pkg, "data.traces").TraceTensors(**vars(tt))
        kw.setdefault("device", "cpu")
    return _m(pkg, "serving.engine_jax").ClusterEngineJAX(
        classes, pol, sim.EngineConfig(prim, ty.Pricing(0.1, 0.2),
                                       n_servers=N, **cfg_kw),
        tt, horizon=HORIZON, **kw)


def _np(raw):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in raw.items()}


def _assert_raw_equal(a, b, skip=()):
    assert set(a) == set(b)
    for k in a:
        if k in skip:
            continue
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        assert x.shape == y.shape, k
        if k in FLOATS:
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


CASES = {
    "gate_and_route": dict(name="gate_and_route"),
    "prioritize_separate": dict(name="prioritize"),
    "vllm_unchunked": dict(name="vllm", cfg_kw=dict(vllm_unchunked=True)),
    "sarathi_immediate": dict(name="sarathi",
                              cfg_kw=dict(sarathi_budget=True)),
    "distserve": dict(name="distserve"),
    "distserve_prefill_only": dict(name="distserve_po"),
    "fcfs_solo_first": dict(name="fcfs_sp"),
    "occupancy_immediate": dict(name="gi_wsp"),
    # per-class deadlines: 7 and 4 abandons a replay
    "expiry": dict(name="gate_and_route", mk_kw=dict(patience=(0.05, 0.5))),
    "expiry_immediate": dict(name="sarathi",
                             mk_kw=dict(patience=(0.05, 0.5))),
    "table_model": dict(name="gate_and_route", cfg_kw=dict(table=True)),
    "fleet": dict(name="gate_and_route", cfg_kw=dict(fleet=_Fleet(N))),
    "gate_and_route_ffwd_k2": dict(name="gate_and_route",
                                   fastforward=True, k_events=2),
    "vllm_ffwd": dict(name="vllm", fastforward=True),
}


def _record_queued(monkeypatch):
    """Wrap the port's step so that it records, per replication, the most
    requests waiting in the class queues after any step (the carry passes
    through unchanged)."""
    ej = _m("repro_torch", "serving.engine_jax")
    build, seen = ej._build_step, {}

    def build_recording(params, **statics):
        step = build(params, **statics)

        def recording(c, *args):
            c = step(c, *args)
            q = (c["st"] == ej._QUEUED).sum(1)
            seen["queued"] = torch.maximum(seen.get("queued", q), q)
            return c
        return recording

    monkeypatch.setattr(ej, "_build_step", build_recording)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_deterministic_parity_with_reference(case, monkeypatch):
    """Every raw carry array equal to the reference's (times and revenue
    within RTOL), two replications in one batch, on a replay in which the
    class queues held two or more jobs at once."""
    kw = CASES[case]
    ref = _engine("repro", **kw)
    port = _engine("repro_torch", **kw)
    assert port.statics == ref.statics
    seen = _record_queued(monkeypatch)
    a = _np(ref.run_batch_raw([0, 1]))
    b = _np(port.run_batch_raw([0, 1]))
    _assert_raw_equal(a, b)
    assert float(b["n_events"][0]) > 1000  # the replay did real work
    assert (seen["queued"] >= 2).all()  # jobs waited for admission
    if case.startswith("expiry"):
        assert (b["abandons"] > 0).all()
    sa, sb = ref.summaries_from_raw(a), port.summaries_from_raw(b)
    for x, y in zip(sa, sb):
        assert x.keys() == y.keys()
        for k in x:
            assert y[k] == pytest.approx(x[k], rel=RTOL, nan_ok=True), k


@pytest.mark.parametrize("name,k", [("gate_and_route", 2), ("vllm", 3),
                                    ("sarathi", 2)])
def test_k_event_blocks_equal_single_events(name, k):
    """The k-event block replays the single-event trajectory in every
    array but the loop-step counter (the reference's
    ``test_k_event_blocks_bitwise``, within the port)."""
    a = _np(_engine("repro_torch", name).run_batch_raw([0, 1]))
    b = _np(_engine("repro_torch", name, k_events=k).run_batch_raw([0, 1]))
    assert (a["n_loop"] >= b["n_loop"]).all()
    for key in set(a) & set(b) - {"n_loop"}:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_fastforward_matches_single_event():
    """Fast-forward replays the same arrivals, the same completions up to
    near-tie flips, and the same revenue within CI half-widths across
    trace seeds (the reference's ``test_fastforward_vs_single_event``)."""
    rev = []
    for s in range(4):
        mk = dict(seed=200 + s)
        m1 = _engine("repro_torch", "gate_and_route", mk_kw=mk).run(0)
        mf = _engine("repro_torch", "gate_and_route", mk_kw=mk,
                     fastforward=True).run(0)
        assert mf["budget_exhausted"] == 0.0
        assert mf["arrivals"] == m1["arrivals"]
        assert mf["completions"] == pytest.approx(m1["completions"],
                                                  rel=0.02, abs=3)
        rev.append((m1["revenue_rate"], mf["revenue_rate"]))
    _ci_close([r[0] for r in rev], [r[1] for r in rev], "revenue_rate")


def test_scan_equals_while():
    """The fixed-length form runs every step of the budget (capped at 400
    of its 2709 here) and ends where the early-exit form does."""
    a = _np(_engine("repro_torch", "gate_and_route",
                    max_steps=400).run_batch_raw([0]))
    b = _np(_engine("repro_torch", "gate_and_route", max_steps=400,
                    loop="scan").run_batch_raw([0]))
    _assert_raw_equal(a, b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_multi_equals_separate_instances():
    """``multi=True`` runs two equal-shape traces in lockstep, each as its
    own replay would."""
    ej = _m("repro_torch", "serving.engine_jax")
    engs = [_engine("repro_torch", "vllm", mk_kw=dict(seed=s))
            for s in (42, 43)]
    st = engs[0].statics
    st["n_steps"] = max(e.n_steps for e in engs)
    params = {k: torch.stack([e.params[k] for e in engs])
              for k in engs[0].params}
    multi = _np(ej.run(params, [0, 1], multi=True, **st))
    for r, e in enumerate(engs):
        one = _np(ej.run(e.params, [r], **st))
        for k in one:
            np.testing.assert_array_equal(multi[k][r], one[k][0], err_msg=k)


def _half_width(v):
    return 1.96 * np.std(v, ddof=1) / np.sqrt(len(v))


def _ci_close(a, b, label, rel_floor=0.0):
    """tests/test_engine_diff.py's ``_ci_close``: two CI half-widths."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    tol = (2.0 * (_half_width(a) + _half_width(b)) + 1e-9
           + rel_floor * max(abs(a.mean()), abs(b.mean())))
    assert abs(a.mean() - b.mean()) <= tol, (
        f"{label}: |{a.mean()} - {b.mean()}| > {tol}")


@pytest.mark.parametrize("name", ["sli", "sli_general"])
def test_randomized_router_statistical_parity(name):
    """The randomized router (pool rings, and the EC.7 pool weights)
    across 6 replications on one trace: revenue and completions within
    two CI half-widths of the reference's; arrivals equal."""
    reps = list(range(6))
    ref = _engine("repro", name)
    port = _engine("repro_torch", name)
    sa = ref.run_batch(reps)
    sb = port.run_batch(reps)
    assert {m["arrivals"] for m in sa} == {m["arrivals"] for m in sb}
    assert max(m["budget_exhausted"] for m in sb) == 0.0
    for key in ("revenue_rate", "completions"):
        _ci_close([m[key] for m in sa], [m[key] for m in sb], key,
                  rel_floor=RTOL)
    # different seeds take different paths on the port too
    assert len({m["n_events"] for m in sb}) > 1


def test_randomized_draws_do_not_depend_on_the_block(monkeypatch):
    """The uniforms are counted by the global event index, so the block
    size of the loop cannot change a randomized replay."""
    ej = _m("repro_torch", "serving.engine_jax")
    eng = _engine("repro_torch", "sli", max_steps=300)
    a = _np(ej.run(eng.params, [3], **eng.statics))
    monkeypatch.setattr(ej, "BLOCK_STEPS", 5)
    b = _np(ej.run(eng.params, [3], **eng.statics))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_budget_exhaustion_detected():
    ref = _engine("repro", "gate_and_route", max_steps=100)
    port = _engine("repro_torch", "gate_and_route", max_steps=100)
    a, b = ref.run(0), port.run(0)
    assert a["budget_exhausted"] == b["budget_exhausted"] == 1.0
    assert b["n_events"] == a["n_events"] == 100.0
    assert _engine("repro_torch", "gate_and_route").run(0)[
        "budget_exhausted"] == 0.0


@pytest.mark.parametrize("case", ["gate_and_route", "sarathi_immediate",
                                  "vllm_unchunked", "table_model", "fleet"])
def test_iteration_budget_bitwise(case):
    kw = CASES[case]
    ref, port = _engine("repro", **kw), _engine("repro_torch", **kw)
    assert port.budget == ref.budget and port.n_steps == ref.n_steps
    ej, rj = (_m("repro_torch", "serving.engine_jax"),
              _m("repro", "serving.engine_jax"))
    assert ej.iteration_budget(port.trace, port.cfg, 7.5) == \
        rj.iteration_budget(ref.trace, ref.cfg, 7.5)


def test_telemetry_probes_match_reference():
    ref = _engine("repro", "gate_and_route", telemetry=True)
    port = _engine("repro_torch", "gate_and_route", telemetry=True)
    a, b = ref.run_batch_raw([0, 1]), port.run_batch_raw([0, 1])
    _assert_raw_equal(_np(a), _np(b))
    _close_tree(port.telemetry_from_raw(b), ref.telemetry_from_raw(a),
                "telemetry")
    one_a = {k: np.asarray(v)[0] for k, v in a.items()}
    one_b = {k: v[0] for k, v in b.items()}
    la = ref.lifecycle_records_from_raw(one_a)
    lb = port.lifecycle_records_from_raw(one_b)
    assert [(r["rid"], r["cls"], r["state"]) for r in la] == \
        [(r["rid"], r["cls"], r["state"]) for r in lb]


def _close_tree(got, want, path):
    """Nested probe reports equal in structure, numbers within RTOL."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close_tree(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), rtol=RTOL,
                                   atol=1e-9, err_msg=path)


def _refusal(pkg, fn):
    with pytest.raises(ValueError) as exc:
        fn(pkg)
    return str(exc.value)


@pytest.mark.parametrize("what", ["gate", "record_queues", "fastforward",
                                  "loop", "k_events", "pool_weights"])
def test_refusals_match_reference(what):
    def build(pkg):
        if what == "gate":
            return _engine(pkg, "gate_and_route", policy_kw=dict(
                gate=_m(pkg, "core.policies").PrefillGate()))
        if what == "record_queues":
            return _engine(pkg, "vllm", cfg_kw=dict(record_queues_every=1.0))
        if what == "fastforward":
            return _engine(pkg, "sli", fastforward=True)
        if what == "loop":
            return _engine(pkg, "vllm", loop="fori")
        if what == "k_events":
            return _engine(pkg, "vllm", k_events=0)
        return _engine(pkg, "sli", policy_kw=dict(
            pool_weights_mixed=np.ones(2)))

    assert _refusal("repro_torch", build) == _refusal("repro", build)


def test_shard_map_placement_names_a8():
    port = _engine("repro_torch", "vllm")
    with pytest.raises(NotImplementedError, match="A8"):
        port.run_batch_raw([0, 1], placement="shard_map")
    with pytest.raises(ValueError, match="placement"):
        port.run_batch_raw([0], placement="pmap")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is legitimately CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        _engine("repro_torch", "vllm", device=None)
