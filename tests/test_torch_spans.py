"""The port's spans (``repro_torch.telemetry.spans``) on the CPU: one
flag check while off, ``cpu_op`` ranges under ``torch.profiler``, records
in memory while recording, nested as called inside ``ServerEngine.step``
of the reduced grok-1 cut, byte counts of the trees the step copies, and
served tokens that do not depend on any of it."""

from contextlib import contextmanager, nullcontext

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.types import ServicePrimitives
from repro_torch.models.model import init_model
from repro_torch.models.params import tree_map, tree_nbytes
from repro_torch.serving import steps
from repro_torch.serving.engine import ServerEngine, SlotRequest
from repro_torch.telemetry import spans, trace
from repro_torch.telemetry.spans import span

B, C = 4, 16


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


def test_off_a_span_is_the_shared_null_context_and_records_nothing():
    with spans.recording():
        pass
    assert not torch.autograd._profiler_enabled()
    cm = span("step.decode", bytes=lambda: pytest.fail("attr evaluated"))
    assert cm is span("model.moe") is spans._NULL
    with cm:
        pass
    assert spans.records() == [] and spans.dropped() == 0


def test_under_the_profiler_a_span_is_a_cpu_op_nested_as_called():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("engine.step", mode="solo"):
            with span("step.decode"):
                torch.ones(3).sum()
            with span("step.sync"):
                pass
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("engine.step", "step.decode", "step.sync"):
        assert ev[name].activity_type() == "cpu_op"
        assert not ev[name].is_user_annotation()
    outer = ev["engine.step"]
    for name in ("step.decode", "step.sync"):
        assert outer.start_ns() <= ev[name].start_ns() \
            <= ev[name].end_ns() <= outer.end_ns()
    assert ev["step.decode"].end_ns() <= ev["step.sync"].start_ns()
    assert ev["step.decode"].start_ns() <= ev["aten::sum"].start_ns()


def _windows(eng):
    """The records of the mixed and of the solo step."""
    got = []

    @contextmanager
    def record():
        with spans.recording():
            yield
        got.append(spans.records())

    _mixed_and_solo(eng, record)
    return got


LAYERS = ["model.mixer", "model.moe"] * 3
# the engine's decode: the inactive rows' caches at the written position
# kept, the layers, and put back
DECODE = ["step.merge"] + LAYERS + ["step.merge"]


def test_a_mixed_and_a_solo_step_emit_their_spans_in_order():
    mixed, solo = _windows(_engine())
    names = lambda recs: [(n, recs[p][0] if p >= 0 else None)  # noqa: E731
                          for n, _, _, p, _ in recs]
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
    for recs in (mixed, solo):
        for n, a, b, p, _ in recs:
            assert a <= b
            if p >= 0:
                assert recs[p][1] <= a and b <= recs[p][2], n
    assert mixed[0][4] == {"mode": "mixed", "decoding": 1,
                           "chunk_tokens": C}
    assert solo[0][4] == {"mode": "solo", "decoding": 2, "chunk_tokens": 0}


def test_the_bytes_attrs_are_the_copied_trees():
    """The engine copies no tree: its merges move the caches at one
    position a row. The pure steps copy the whole caches once."""
    eng = _engine()
    caches = eng.state["caches"]
    full = sum(a.numel() * a.element_size() for a in
               (x for seg in caches for b in seg.values()
                for x in b.values()))
    slot = tree_nbytes(tree_map(lambda a: a[:, :1], caches))
    assert slot * B == full
    mixed, solo = _windows(eng)
    by = lambda recs, n: [r[4]["bytes"] for r in recs  # noqa: E731
                          if r[0] == n]
    at_one_position = full // eng.max_len  # every leaf is (rep, B, S, ...)
    for recs in (mixed, solo):
        assert by(recs, "step.merge") == [at_one_position] * 2
        assert by(recs, "step.write_slot") == by(recs, "model.cache_clone") \
            == []
    state = eng.state
    with spans.recording():
        steps.make_mixed_step(eng.cfg, C)(
            eng.params, state, 3, torch.zeros(C, dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), kv_len=C)
        steps.make_decode_step(eng.cfg)(eng.params, state)
    assert by(spans.records(), "model.cache_clone") == [full, full]


def test_the_served_tokens_do_not_depend_on_the_spans():
    off = _mixed_and_solo(_engine(), nullcontext)
    with profile(activities=[ProfilerActivity.CPU]), spans.recording():
        on = _mixed_and_solo(_engine(), nullcontext)
    assert len(spans.records()) > 100
    assert on == off and len(on[0]) == len(on[1]) == 6


def test_the_records_render_as_a_valid_trace(tmp_path):
    mixed, _ = _windows(_engine())
    ev = trace.span_events(mixed)
    assert len(ev) == len(mixed)
    assert {e["pid"] for e in ev} == {3} and ev[0]["ts"] == 0.0
    assert ev[0]["args"]["mode"] == "mixed"
    assert trace.validate_trace(trace.trace_payload(ev)) == []
    p = trace.write_trace(tmp_path / "spans.json", ev)
    assert trace.validate_trace(p) == []


def test_a_full_window_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 2)
    with spans.recording():
        with span("engine.step"):
            with span("step.decode"):
                with span("step.merge"):
                    pass
            with span("step.sync"):
                pass
    assert [r[0] for r in spans.records()] == ["engine.step", "step.decode"]
    assert spans.dropped() == 2
    assert all(r[2] is not None for r in spans.records())
