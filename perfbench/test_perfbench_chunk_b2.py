"""``chunk_b2_share``'s reader on the program's counter
(``repro_torch.telemetry.counters.chunk_totals``): the share of the
continuation chunks' attention calls that ran through B2, None where the
configuration has no attention layer."""

import types

import pytest

from perfbench import harness

CFG = harness.load_config("grok1-2l")


@pytest.mark.parametrize("pattern,counted,want", [
    (["attn"], (0, 0), 0.0),  # attention layers, nothing counted
    (["attn"], (3, 1), 75.0),
    (["attn_local", "attn"], (2, 2), 50.0),
    (["mla"], (3, 1), None),  # no attention layer: nothing to read
    (["ssm"], (0, 0), None)])
def test_chunk_b2_share_reads_the_counter(pattern, counted, want):
    from repro_torch.telemetry import counters

    run = types.SimpleNamespace(
        cfg=dict(CFG, model=dict(CFG["model"], pattern=pattern)))
    counters.reset()
    for b2, n in zip((True, False), counted):
        for _ in range(n):
            counters.chunk_attention(b2)
    assert counters.chunk_totals() == dict(zip(("b2", "blockwise"), counted))
    got = harness._reader("chunk_b2_share", harness.HERE)(run)
    counters.reset()
    assert got == (None if want is None else pytest.approx(want))
