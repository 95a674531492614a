"""The port's spans (``repro_torch.telemetry.spans``) on the CPU: one
flag check while off, ``cpu_op`` ranges under ``torch.profiler``, nested
as called inside ``ServerEngine.step`` of the reduced grok-1 cut, their
attrs in the exported Chrome trace (byte counts of what the step moves),
and served tokens that do not depend on any of it."""

import json
from contextlib import contextmanager, nullcontext

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.types import ServicePrimitives
from repro_torch.models.model import init_model
from repro_torch.models.params import tree_map, tree_nbytes
from repro_torch.serving.engine import ServerEngine, SlotRequest
from repro_torch.telemetry import spans
from repro_torch.telemetry.spans import span

B, C = 4, 16
SPAN_PREFIXES = ("engine.", "step.", "model.")


def _engine():
    cfg = get_config("grok-1-314b", reduced=True)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return ServerEngine(cfg, params, prim=ServicePrimitives(batch_cap=B,
                                                            chunk=C),
                        max_len=64, device="cpu")


def _admit(eng, rid, n, decode_len):
    eng.start_prefill(SlotRequest(rid, 0, n, decode_len),
                      np.arange(2, 2 + n) * (rid + 3) % 500)


def _prefill(eng):
    """Steps until the staged prompt is in its slot; activates it."""
    while True:
        res = eng.step()
        if res["prefill_done"] is not None:
            eng.activate_slot(res["prefill_slot"])
            return res["prefill_done"]


def _mixed_and_solo(eng, record):
    """One request decoding, a second prompt's first chunk beside it (a
    mixed step), then, with both decoding, a solo step: ``record`` wraps
    those two steps. Returns the two requests' tokens at the end."""
    _admit(eng, 0, 10, 6)
    a = _prefill(eng)
    _admit(eng, 1, 20, 6)
    with record():
        eng.step()
    b = _prefill(eng)
    with record():
        eng.step()
    while a.tokens_out < a.decode_len or b.tokens_out < b.decode_len:
        eng.step()
    return a.out_tokens, b.out_tokens


def _exported(prof, tmp_path):
    """The ``cpu_op`` events of the profiler's exported Chrome trace."""
    path = tmp_path / "steps.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "cpu_op"]


def test_off_a_span_is_the_shared_null_context_and_records_nothing():
    """While the profiler is off no attr is evaluated."""
    assert not torch.autograd._profiler_enabled()
    cm = span("step.decode", bytes=lambda: pytest.fail("attr evaluated"))
    assert cm is span("model.moe") is spans._NULL
    with cm:
        pass


def test_under_the_profiler_a_span_is_a_cpu_op_nested_as_called(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("engine.step", mode="solo"):
            with span("step.decode"):
                torch.ones(3).sum()
            with span("step.sync"):
                pass
    names = {e["name"] for e in _exported(prof, tmp_path)}
    assert {"engine.step", "step.decode", "step.sync"} <= names
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer = ev["engine.step"]
    for name in ("step.decode", "step.sync"):
        assert outer.start_ns() <= ev[name].start_ns() \
            <= ev[name].end_ns() <= outer.end_ns()
    assert ev["step.decode"].end_ns() <= ev["step.sync"].start_ns()
    assert ev["step.decode"].start_ns() <= ev["aten::sum"].start_ns()


def test_a_callable_attr_is_called_once_per_span_under_the_profiler(
        tmp_path):
    calls = []

    def count():
        calls.append(1)
        return len(calls)

    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for _ in range(3):
            with span("step.merge", bytes=count, mode="solo"):
                pass
    assert len(calls) == 3
    got = [e["args"] for e in _exported(prof, tmp_path)
           if e["name"] == "step.merge"]
    assert [(a["bytes"], a["mode"]) for a in got] == [
        (1, "solo"), (2, "solo"), (3, "solo")]


def _windows(eng, tmp_path):
    """For the mixed and the solo step, the spans as ``(name, parent,
    start_ns, end_ns)`` in the order they opened (a span's parent: the
    innermost span around it), and the exported spans' attrs in the same
    order."""
    got = []

    @contextmanager
    def record():
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            yield
        ev = sorted(((e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(SPAN_PREFIXES)),
                    key=lambda e: (e[1], -e[2]))
        recs, open_ = [], []
        for name, a, b in ev:
            while open_ and open_[-1][2] < b:
                open_.pop()
            recs.append((name, open_[-1][0] if open_ else None, a, b))
            open_.append((name, a, b))
        exp = sorted((e for e in _exported(prof, tmp_path)
                      if e["name"].startswith(SPAN_PREFIXES)),
                     key=lambda e: (e["ts"], -e["dur"]))
        assert [e["name"] for e in exp] == [r[0] for r in recs]
        got.append((recs, [e["args"] for e in exp]))

    _mixed_and_solo(eng, record)
    return got


LAYERS = ["model.mixer", "model.moe"] * 3
# the engine's decode: the inactive rows' caches at the written position
# kept, the layers, and put back
DECODE = ["step.merge"] + LAYERS + ["step.merge"]


def test_a_mixed_and_a_solo_step_emit_their_spans_in_order(tmp_path):
    (mixed, m_args), (solo, s_args) = _windows(_engine(), tmp_path)
    names = lambda recs: [r[:2] for r in recs]  # noqa: E731
    assert names(mixed) == (
        [("engine.step", None), ("step.chunk", "engine.step")]
        + [(n, "step.chunk") for n in LAYERS]
        + [("step.decode", "engine.step")]
        + [(n, "step.decode") for n in DECODE]
        + [("step.sync", "engine.step"), ("step.account", "engine.step")])
    assert names(solo) == (
        [("engine.step", None), ("step.decode", "engine.step")]
        + [(n, "step.decode") for n in DECODE]
        + [("step.sync", "engine.step"), ("step.account", "engine.step")])
    attrs = ("mode", "decoding", "chunk_tokens")
    assert {k: m_args[0][k] for k in attrs} == {
        "mode": "mixed", "decoding": 1, "chunk_tokens": C}
    assert {k: s_args[0][k] for k in attrs} == {
        "mode": "solo", "decoding": 2, "chunk_tokens": 0}


def test_the_bytes_attrs_are_the_copied_trees(tmp_path):
    """The engine copies no tree: its merges move the caches at one
    position a row."""
    eng = _engine()
    caches = eng.state["caches"]
    full = sum(a.numel() * a.element_size() for a in
               (x for seg in caches for b in seg.values()
                for x in b.values()))
    slot = tree_nbytes(tree_map(lambda a: a[:, :1], caches))
    assert slot * B == full
    at_one_position = full // eng.max_len  # every leaf is (rep, B, S, ...)
    for recs, args in _windows(eng, tmp_path):
        by = lambda n: [a["bytes"] for r, a in zip(recs, args)  # noqa: E731
                        if r[0] == n]
        assert by("step.merge") == [at_one_position] * 2
        assert by("step.write_slot") == []


def test_the_served_tokens_do_not_depend_on_the_spans():
    off = _mixed_and_solo(_engine(), nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _mixed_and_solo(_engine(), nullcontext)
    assert sum(e.name().startswith(SPAN_PREFIXES)
               for e in prof.profiler.kineto_results.events()) > 100
    assert on == off and len(on[0]) == len(on[1]) == 6


def test_an_exported_engine_step_holds_its_spans_and_attrs(tmp_path):
    """The operator's recipe: ``profile(record_shapes=True)`` around
    ``ServerEngine.step``, then ``export_chrome_trace``."""
    eng = _engine()
    _admit(eng, 0, 10, 6)
    _prefill(eng)
    _admit(eng, 1, 20, 6)
    with profile(record_shapes=True) as prof:
        eng.step()
        eng.step()
    ev = _exported(prof, tmp_path)
    steps = [e["args"] for e in ev if e["name"] == "engine.step"]
    assert [(a["mode"], a["decoding"], a["chunk_tokens"]) for a in steps] \
        == [("mixed", 1, C), ("mixed", 1, 20 - C)]
    at_one_position = tree_nbytes(eng.state["caches"]) // eng.max_len
    merges = [e["args"]["bytes"] for e in ev if e["name"] == "step.merge"]
    assert merges == [at_one_position] * 4
