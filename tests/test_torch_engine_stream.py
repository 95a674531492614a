"""The port's streamed replay (``repro_torch.serving.engine_stream``) on
the CPU: streamed equals batch within the port, the port's stream equals
the reference's, its errors are the reference's, and every registry
scenario replays without exhausting the step budget.

The instance is ``tests/test_engine_diff.py``'s stream instance (seed 7,
compression 0.3, horizon 30, window 512, 183 requests).  Discrete
outcomes are held exactly; revenue within 1e-5 relative and the TTFT
mean within 1e-4 relative, the reference's own stream-vs-batch
tolerances.
"""

import dataclasses
import importlib
import re

import jax  # noqa: F401  (JAX and PyTorch share the process)
import numpy as np
import pytest
import torch  # noqa: F401

N = 8
HORIZON = 30.0
PAD = 512
# the registry run's horizon on the CPU: the reference's test replays 60 s
# (tests/test_engine_diff.py); the eager CPU step takes 20 s here, and the
# card runs the full 60 s (tests/test_torch_gpu.py)
REGISTRY_HORIZON = 20.0

_CACHE = {}


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _instance(pkg):
    """(trace without deadlines, classes, plan, config) of one package."""
    if pkg not in _CACHE:
        tr, ty, pl = _m(pkg, "data.traces"), _m(pkg, "core.types"), \
            _m(pkg, "core.planning")
        trace = tr.synth_azure_trace(tr.TraceConfig(
            horizon=HORIZON, base_rate=2.0, compression=0.3, seed=7))
        trace = [dataclasses.replace(r, patience=float("inf"))
                 for r in trace]
        classes = [ty.WorkloadClass(nm, m[0], m[1], m[2] / N, patience=3e-4)
                   for nm, m in zip(("code", "conv"),
                                    tr.trace_class_means(trace, 2))]
        prim, price = ty.ServicePrimitives(), ty.Pricing(0.1, 0.2)
        plan = pl.solve_bundled_lp(classes, prim, price,
                                   sli=pl.SLISpec(pin_zero_decode_queue=True))
        cfg = _m(pkg, "serving.engine_sim").EngineConfig(prim, price,
                                                         n_servers=N)
        _CACHE[pkg] = (trace, classes, plan, cfg)
    return _CACHE[pkg]


def _policy(pkg, name, plan):
    p = _m(pkg, "core.policies")
    return {"gate_and_route": p.gate_and_route, "vllm": p.baseline_vllm,
            "sli": p.sli_aware_policy}[name](plan)


def _kw(pkg):
    return {"device": "cpu"} if pkg == "repro_torch" else {}


def _stream_engine(pkg, name, window=PAD):
    trace, classes, plan, cfg = _instance(pkg)
    return _m(pkg, "serving.engine_stream").StreamingEngineJAX(
        classes, _policy(pkg, name, plan), cfg, horizon=HORIZON,
        window=window, **_kw(pkg))


def _stream(pkg, name, chunk):
    key = (pkg, name, chunk)
    if key not in _CACHE:
        trace = _instance(pkg)[0]
        es = _m(pkg, "serving.engine_stream")
        _CACHE[key] = _stream_engine(pkg, name).run_stream(
            es.TraceChunkSource(trace, chunk_size=chunk), seed=0)
    return _CACHE[key]


def _batch(name):
    key = ("batch", name)
    if key not in _CACHE:
        trace, classes, plan, cfg = _instance("repro_torch")
        tt = _m("repro_torch", "data.traces").tensorize_trace(trace)
        _CACHE[key] = _m("repro_torch", "serving.engine_jax") \
            .ClusterEngineJAX(classes, _policy("repro_torch", name, plan),
                              cfg, tt, horizon=HORIZON, drain=True,
                              fastforward=True, device="cpu").run(0)
    return _CACHE[key]


@pytest.mark.parametrize("name", ["gate_and_route", "vllm"])
@pytest.mark.parametrize("chunk", [64, 160])
def test_stream_matches_batch(name, chunk):
    """A chunk-fed streamed replay reproduces the drain-mode batch replay
    of the same trace (the reference's ``test_stream_matches_batch``)."""
    ref, s = _batch(name), _stream("repro_torch", name, chunk)
    assert s["arrivals"] == ref["arrivals"]
    assert s["completions"] == ref["completions"]
    assert s["abandons"] == ref["abandons"]
    assert s["budget_exhausted"] == 0.0
    assert s["revenue_rate"] == pytest.approx(ref["revenue_rate"], rel=1e-5)
    assert s["ttft_mean"] == pytest.approx(ref["ttft_mean"], rel=1e-4)
    assert s["n_segments"] >= 2  # the test crossed a seam


@pytest.mark.parametrize("name,chunk", [("gate_and_route", 160),
                                        ("vllm", 64)])
def test_stream_matches_reference_stream(name, chunk):
    a, b = _stream("repro", name, chunk), _stream("repro_torch", name, chunk)
    for k in ("arrivals", "completions", "abandons", "requests",
              "n_segments", "window_peak", "window_occupancy",
              "budget_exhausted", "n_events", "n_iters", "n_loop",
              "n_steps"):
        assert b[k] == a[k], k
    for k in ("revenue_rate", "t_end", "tpot_mean"):
        assert b[k] == pytest.approx(a[k], rel=1e-5), k
    assert b["ttft_mean"] == pytest.approx(a["ttft_mean"], rel=1e-4)


class _Chunks:
    def __init__(self, chunks):
        self._it = iter(chunks)

    def next_chunk(self):
        return next(self._it, None)


def _errors(pkg):
    """The (type, message) of each source-validation error."""
    trace = _instance(pkg)[0]
    tr, es = _m(pkg, "data.traces"), _m(pkg, "serving.engine_stream")
    chunks = tr.chunk_trace(trace, 64)
    se = _stream_engine(pkg, "vllm")
    finite = [dataclasses.replace(r, patience=0.5) for r in trace]
    cases = [
        lambda: se.run_stream(_Chunks(chunks[::-1])),
        lambda: es.TraceChunkSource([chunks[0],
                                     tr.tensorize_trace(trace, pad_to=256)]),
        lambda: _stream_engine(pkg, "sli"),
        lambda: se.run_stream(es.TraceChunkSource(finite, chunk_size=64)),
    ]
    out = []
    for case in cases:
        with pytest.raises(ValueError) as exc:
            case()
        out.append((type(exc.value).__name__, str(exc.value)))
    return out


def test_source_validation_errors_match_reference():
    got, want = _errors("repro_torch"), _errors("repro")
    assert got == want
    assert [w[0] for w in got] == ["TraceValidationError",
                                   "TraceValidationError", "ValueError",
                                   "ValueError"]


@pytest.mark.parametrize("chunk", [64, 8])
def test_window_overflow_is_loud_and_matches_reference(chunk):
    """An undersized working set raises with the recent per-segment
    occupancy trace; the port's message is the reference's."""
    msgs = []
    for pkg in ("repro", "repro_torch"):
        trace = _instance(pkg)[0]
        es = _m(pkg, "serving.engine_stream")
        with pytest.raises(RuntimeError, match="window") as exc:
            _stream_engine(pkg, "vllm", window=16).run_stream(
                es.TraceChunkSource(trace, chunk_size=chunk), seed=0)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]
    assert "occupancy after recent splices" in msgs[1]
    if chunk == 8:
        assert re.search(r"seg\d+=\d+", msgs[1]), msgs[1]


@pytest.mark.parametrize(
    "scenario", _m("repro_torch", "workloads").list_scenarios())
def test_registry_scenario_budget_not_exhausted(scenario):
    """Every registry scenario replays to the horizon with the step budget
    never exhausted: streamed from a ScenarioStream where it can (no
    deadlines), host-padded otherwise (the reference's
    ``test_registry_scenarios_budget_not_exhausted``, horizon cut to
    REGISTRY_HORIZON on the CPU)."""
    from repro_torch.core.planning import solve_bundled_lp
    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import Pricing, ServicePrimitives, \
        WorkloadClass
    from repro_torch.data.traces import tensorize_trace
    from repro_torch.serving.engine_jax import ClusterEngineJAX
    from repro_torch.serving.engine_sim import EngineConfig
    from repro_torch.serving.engine_stream import StreamingEngineJAX
    from repro_torch.workloads import get_scenario
    from repro_torch.workloads.batch import ScenarioStream

    prim, price = ServicePrimitives(), Pricing(0.1, 0.2)
    sc = get_scenario(scenario)
    shares = np.array([p.share for p in sc.profiles])
    shares = shares / shares.sum()
    classes = [WorkloadClass(p.name, int(p.mean_prompt), int(p.mean_decode),
                             max(float(2.0 * sh / 6), 1e-3))
               for p, sh in zip(sc.profiles, shares)]
    plan = solve_bundled_lp(classes, prim, price)
    cfg = EngineConfig(prim, price, n_servers=6)
    h = REGISTRY_HORIZON
    if all(np.isinf(p.patience) for p in sc.profiles):
        eng = StreamingEngineJAX(classes, gate_and_route(plan), cfg,
                                 horizon=h, window=4096, device="cpu")
        m = eng.run_stream(ScenarioStream(sc, seed=0, chunk_size=512,
                                          horizon=h, device="cpu"), seed=0)
    else:
        m = ClusterEngineJAX(classes, gate_and_route(plan), cfg,
                             tensorize_trace(sc.generate(seed=0, horizon=h)),
                             horizon=h, device="cpu").run(0)
    assert m["budget_exhausted"] == 0.0
    assert m["arrivals"] > 0
