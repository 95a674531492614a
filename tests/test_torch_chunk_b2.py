"""A continuation chunk's attention through B2, on the CPU its plain
version: ``prefill_attention_plain`` given ``q_offset`` and ``kv_len``
against the blockwise continuation it replaces, and
``attention_prefill(continuation=True)``'s route by the cache's form,
read from the program's counter (``repro_torch.telemetry.counters``);
the JAX package holds the routed chunk in ``tests/test_torch_models.py``.

The blockwise path is the one ``tests/test_torch_attention.py`` and
``tests/test_torch_models.py`` hold to the reference.  f32 is held to
1e-6; bf16 inputs to the blockwise path over the same values widened to
f32 within one bf16 rounding of the output (the plain version computes
in f32 and rounds once), and to the blockwise path in bf16 within 5e-2
of the largest output (it rounds P to bf16 before P.V, as the
reference does)."""

import pytest
import torch

from repro_torch.kernels.prefill_attention.ops import prefill_attention_plain
from repro_torch.models import attention as TA
from repro_torch.models.config import AttentionConfig
from repro_torch.models.params import init_params
from repro_torch.telemetry import counters

S_CACHE, C, H, KV, D = 96, 16, 12, 2, 16  # G = 6, grok's 48 / 8


def _cache_with_chunk(dtype, off, seed=0):
    """q for a chunk at positions off .. off + C - 1, over a cache whose
    first off + C slots hold this request's keys; the slots past them
    hold an earlier, longer request's keys and positions."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, C, H, D, generator=g).to(dtype)
    k, v = (torch.randn(1, S_CACHE, KV, D, generator=g).to(dtype)
            for _ in range(2))
    pos = torch.arange(S_CACHE, dtype=torch.int32)[None]  # stale past end
    return q, k, v, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap", [None, 30.0], ids=["nocap", "cap30"])
@pytest.mark.parametrize("off", [0, 40, S_CACHE - C],
                         ids=["start", "mid", "last-slot"])
def test_plain_chunk_matches_the_blockwise_continuation(dtype, softcap, off):
    q, k, v, pos = _cache_with_chunk(dtype, off)
    q_pos = torch.arange(off, off + C, dtype=torch.int32)
    ends = torch.tensor([off + C], dtype=torch.int32)

    def blockwise(q, k, v):
        return TA.blockwise_attention(q, k, v, q_positions=q_pos,
                                      k_positions=pos[0], kv_len=ends,
                                      attn_softcap=softcap)

    got = prefill_attention_plain(q, k, v, attn_softcap=softcap,
                                  q_offset=q_pos[:1], kv_len=ends)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, blockwise(q, k, v), atol=1e-6,
                                   rtol=1e-6)
    else:
        wide = blockwise(q.float(), k.float(), v.float())
        torch.testing.assert_close(got.float(), wide, atol=1e-5,
                                   rtol=2.0 ** -7)
        want = blockwise(q, k, v).float()
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=5e-2 * float(want.abs().max()))
    # what lies past the chunk's end does not reach it
    k2, v2 = k.clone(), v.clone()
    k2[:, off + C:], v2[:, off + C:] = 1e4, -1e4
    assert torch.equal(prefill_attention_plain(
        q, k2, v2, attn_softcap=softcap, q_offset=q_pos[:1], kv_len=ends),
        got)


# the cache's form -> (init_kv_cache's keywords, attention_prefill's,
# whether the chunk runs through B2; None: the call is refused)
FORMS = {
    "plain": ({}, {}, True),
    "ring": ({"ring_window": 32}, {"local": True}, False),
    "int8": ({"quant": True}, {}, False),
    "bf16-under-f32": ({"dtype": torch.bfloat16}, {}, False),
    "past-the-cache": ({}, {"kv_len": S_CACHE + 1}, False),
    "no-kv_len": ({}, {"kv_len": None}, None),
    "prefix-LM": ({}, {"prefix_len": 4}, False),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_continuation_routes_by_the_cache_form(form):
    """Through B2 over a plain cache in the queries' dtype; blockwise
    over a ring, int8 K/V, a cache in another dtype, a prefix-LM mask or
    a chunk ending past the cache; refused without ``kv_len``.  That the
    routes compute the reference's chunk, ``tests/test_torch_models.py``
    checks against the JAX package."""
    cache_kw, call_kw, on_b2 = FORMS[form]
    cfg = AttentionConfig(n_heads=H, n_kv_heads=KV, head_dim=D,
                          attn_softcap=30.0, window=32)
    d = 32
    p = init_params(TA.attn_defs(cfg, d), torch.Generator().manual_seed(1),
                    device="cpu")
    g = torch.Generator().manual_seed(2)
    x0, x1 = (torch.randn(1, n, d, generator=g) for n in (40, C))
    pos = torch.arange(40 + C, dtype=torch.int32)[None]

    def run():
        kw = dict({"dtype": torch.float32}, **cache_kw)
        cache = TA.init_kv_cache(1, S_CACHE, KV, D, kw.pop("dtype"),
                                 device="cpu", **kw)
        kw = dict({"local": False, "kv_len": 40 + C}, **call_kw)
        _, cache = TA.attention_prefill(cfg, p, x0, pos[:, :40], cache=cache,
                                        local=kw["local"])
        return TA.attention_prefill(cfg, p, x1, pos[:, 40:], cache=cache,
                                    continuation=True, **kw)[0]

    counters.reset()
    if on_b2 is None:
        with pytest.raises(ValueError, match="kv_len"), \
                torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
            run()
        assert counters.chunk_totals() == {"b2": 0, "blockwise": 0}
        return
    run()  # the profiler is off: nothing is counted
    assert counters.chunk_totals() == {"b2": 0, "blockwise": 0}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        run()
    assert counters.chunk_totals() == {"b2": int(on_b2),
                                       "blockwise": int(not on_b2)}
    counters.reset()
    assert counters.chunk_totals() == {"b2": 0, "blockwise": 0}
