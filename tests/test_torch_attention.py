"""The port's attention layer held to the JAX package on the CPU.

``repro_torch.models.attention`` and its rotary embeddings against
``repro.models.attention`` on the same inputs, numpy draws from fixed
seeds: the blockwise prefill under each mask, decode over a wrapped ring
cache (B1's plain version on the CPU), the cache writers (bitwise, int8
quantised caches included), and the whole layer with
``kernel_impl="pallas"`` (B2's plain version) against the reference's
``"xla"`` and its Pallas kernel in interpret mode.

Tolerances: rotary embeddings 1e-6 absolute (both rotate in f32; sin
and cos may differ by an ulp).  Attention in f32 1e-5 relative to the
largest magnitude (summation order only); in bf16 5e-2 (the model-level
tolerance of ``tests/test_torch_ssm.py``): the reference rounds P to
bf16 before P·V where B1 and B2 keep it in f32.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import layers as RL
from repro.models.config import AttentionConfig as RefAttentionConfig
from repro.models.params import init_params as ref_init_params
from repro_torch.kernels.decode_attention.ops import decode_attention as b1
from repro_torch.kernels.prefill_attention.ops import prefill_attention as b2
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.config import AttentionConfig
from repro_torch.models.params import params_from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 5e-2}


def _close(got, want, rel):
    """|got - want| <= rel x (|want| + max |want|)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _draw(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _both(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.array(a)).to(tdt)


# ------------------------------------------------------------------ rope


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(dtype, theta):
    B, S, H, D = 2, 40, 3, 16
    pos = np.stack([np.arange(S), np.arange(S) + 1000]).astype(np.int32)
    rs, rc = RL.rope_table(jnp.asarray(pos), D, theta)
    ts, tc = TL.rope_table(torch.from_numpy(pos), D, theta)
    assert ts.dtype == torch.float32 and ts.shape == (B, S, D // 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=1e-6)
    jx, tx = _both(_draw((B, S, H, D), 0), dtype)
    want = RL.apply_rope(jx, rs, rc)
    got = TL.apply_rope(tx, ts, tc)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    else:  # one bf16 rounding of values within 1e-6 of each other
        _close(got, want, 2.0 ** -7)


# ------------------------------------------------------------ blockwise

MASKS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=24),
    "prefix": dict(causal=True, prefix_len=20),
    "softcap": dict(causal=True, attn_softcap=5.0),
    "non-causal": dict(causal=False),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask", list(MASKS))
def test_blockwise_attention_matches_reference(mask, dtype):
    B, S, H, KV, D = 2, 80, 4, 2, 16
    jq, tq = _both(_draw((B, S, H, D), 1), dtype)
    jk, tk = _both(_draw((B, S, KV, D), 2), dtype)
    jv, tv = _both(_draw((B, S, KV, D), 3), dtype)
    pos = np.arange(S, dtype=np.int32)
    kw = MASKS[mask]
    # block_q=32 gives several query blocks with statically cut KV ranges
    want = jax.jit(partial(RA.blockwise_attention, block_q=32, **kw))(
        jq, jk, jv, q_positions=jnp.asarray(pos),
        k_positions=jnp.asarray(pos))
    got = TA.blockwise_attention(tq, tk, tv,
                                 q_positions=torch.from_numpy(pos),
                                 k_positions=torch.from_numpy(pos),
                                 block_q=32, **kw)
    assert got.dtype == tv.dtype and got.shape == (B, S, H, D)
    _close(got, want, REL[dtype])


@pytest.mark.parametrize("window", [None, 24])
def test_blockwise_continuation_with_kv_len_matches_reference(window):
    """A chunk at positions 40..55 over a cache whose slots hold 0..55 and
    -1 (empty) past them, masked by ``kv_len``."""
    B, C, S_cache, H, KV, D = 2, 16, 64, 4, 2, 16
    q = _draw((B, C, H, D), 4)
    k, v = _draw((B, S_cache, KV, D), 5), _draw((B, S_cache, KV, D), 6)
    qpos = np.arange(40, 40 + C, dtype=np.int32)
    kpos = np.where(np.arange(S_cache) < 56, np.arange(S_cache), -1).astype(
        np.int32)
    kv_len = np.array([56, 50], np.int32)
    kw = dict(causal=True, window=window, attn_softcap=5.0)
    want = RA.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
        kv_len=jnp.asarray(kv_len), **kw)
    got = TA.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos),
        kv_len=torch.from_numpy(kv_len), **kw)
    _close(got, want, REL["float32"])


# --------------------------------------------------------------- decode


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_on_a_wrapped_ring_matches_reference(dtype):
    """A ring of 32 slots after 75 tokens: slot s holds position
    64 + s for s < 11, else 32 + s; window 24 and softcap on top."""
    B, S, H, KV, D = 2, 32, 4, 2, 16
    jq, tq = _both(_draw((B, 1, H, D), 7), dtype)
    jk, tk = _both(_draw((B, S, KV, D), 8), dtype)
    jv, tv = _both(_draw((B, S, KV, D), 9), dtype)
    s = np.arange(S)
    kpos = np.stack([np.where(s < 11, 64 + s, 32 + s),
                     np.where(s < 3, 32 + s, s)]).astype(np.int32)
    qpos = np.array([74, 34], np.int32)
    kv_len = np.minimum(qpos + 1, S).astype(np.int32)
    kw = dict(window=24, attn_softcap=5.0)
    want = RA.decode_attention(jq, jk, jv, kv_len=jnp.asarray(kv_len),
                               k_positions=jnp.asarray(kpos),
                               q_positions=jnp.asarray(qpos), **kw)
    n = b1.launches
    got = TA.decode_attention(tq, tk, tv, kv_len=torch.from_numpy(kv_len),
                              k_positions=torch.from_numpy(kpos),
                              q_positions=torch.from_numpy(qpos), **kw)
    assert b1.launches == n  # the CPU runs B1's plain version
    assert got.dtype == tv.dtype and got.shape == (B, 1, H, D)
    _close(got, want, REL[dtype])


def test_decode_attention_promotes_bf16_queries_against_an_f32_cache():
    B, S, H, KV, D = 2, 20, 4, 2, 16
    q = _draw((B, 1, H, D), 10)
    k, v = _draw((B, S, KV, D), 11), _draw((B, S, KV, D), 12)
    kv_len = np.array([20, 7], np.int32)
    want = RA.decode_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k),
                               jnp.asarray(v), kv_len=jnp.asarray(kv_len))
    got = TA.decode_attention(torch.from_numpy(q).to(torch.bfloat16),
                              torch.from_numpy(k), torch.from_numpy(v),
                              kv_len=torch.from_numpy(kv_len))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, REL["float32"])


# ---------------------------------------------------------------- caches


def _kv_caches(B, max_len, ring, quant, dtype):
    jdt, tdt = DTYPES[dtype]
    return (RA.init_kv_cache(B, max_len, 2, 16, jdt, ring_window=ring,
                             quant=quant),
            TA.init_kv_cache(B, max_len, 2, 16, tdt, ring_window=ring,
                             quant=quant, device="cpu"))


def _bitwise(got, want):
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key]
        assert tuple(g.shape) == w.shape, key
        if w.dtype.name == "bfloat16":
            w, g = w.astype(np.float32), g.float()
        np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ring,S", [(None, 20), (32, 20), (32, 45)])
def test_cache_writes_match_reference_bitwise(ring, S, quant, dtype):
    """Prefill at positions 3.. (longer than the ring in the last case,
    so only its last 32 tokens land), then two decode writes."""
    B = 2
    rc, tc = _kv_caches(B, 64, ring, quant, dtype)
    jk, tk = _both(_draw((B, S, 2, 16), 13, scale=3.0), dtype)
    jv, tv = _both(_draw((B, S, 2, 16), 14, scale=3.0), dtype)
    pos = np.broadcast_to(np.arange(3, 3 + S)[None], (B, S)).astype(np.int32)
    rc = RA.cache_write_prefill(rc, jk, jv, jnp.asarray(pos))
    tc = TA.cache_write_prefill(tc, tk, tv, torch.from_numpy(pos))
    _bitwise(tc, rc)
    for step in range(2):
        jk, tk = _both(_draw((B, 1, 2, 16), 15 + step), dtype)
        jv, tv = _both(_draw((B, 1, 2, 16), 17 + step), dtype)
        dpos = np.array([3 + S + step, 3 + S + 2 * step], np.int32)
        rc = RA.cache_write_decode(rc, jk, jv, jnp.asarray(dpos))
        tc = TA.cache_write_decode(tc, tk, tv, torch.from_numpy(dpos))
        _bitwise(tc, rc)
    if quant:
        assert tc["k"].dtype == torch.int8 and tc["k_s"].dtype == torch.float16
    jdt, tdt = DTYPES[dtype]
    for got, want in zip(TA.cache_kv_arrays(tc, tdt),
                         RA.cache_kv_arrays(rc, jdt)):
        _bitwise({"x": got}, {"x": want})


@pytest.mark.parametrize("quant", [False, True])
def test_cache_writes_go_into_the_cache_they_are_given(quant):
    """Unlike the reference's, the writers update the cache's own tensors
    (the model copies a segment's caches once per call)."""
    _, tc = _kv_caches(2, 8, None, quant, "float32")
    leaves = dict(tc)
    k = torch.ones((2, 1, 2, 16))
    out = TA.cache_write_decode(tc, k, 2 * k, torch.tensor([3, 5],
                                                           dtype=torch.int32))
    assert all(out[n] is a for n, a in leaves.items())
    assert tc["pos"][:, 3].tolist() == [3, -1]
    assert tc["pos"][:, 5].tolist() == [-1, 5]


# ------------------------------------------------------------ the layer


def _layer(cfg_kw, seed=0):
    ref_cfg = RefAttentionConfig(**cfg_kw)
    cfg = AttentionConfig(**cfg_kw)
    d = 32
    p = jax.tree.map(np.asarray, ref_init_params(RA.attn_defs(ref_cfg, d),
                                                 jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):  # the init's zero biases would hide them
        if b in p:
            p[b] = (0.5 * rng.standard_normal(p[b].shape)).astype(np.float32)
    return ref_cfg, cfg, d, p, params_from_numpy(p, "cpu")


LAYERS = {
    "qwen2": dict(n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
                  rope_theta=1e6),
    "gemma2-local": dict(n_heads=4, n_kv_heads=2, head_dim=16, window=32,
                         attn_softcap=50.0),
}


@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("S", [40, 128])
def test_attention_prefill_pallas_matches_reference(layer, S):
    """``kernel_impl="pallas"`` on the CPU (B2's plain version) against the
    reference's ``"xla"`` and its Pallas kernel in interpret mode, with the
    cache written and one decode after it."""
    ref_cfg, cfg, d, rp, tp = _layer(LAYERS[layer])
    local = cfg.window is not None
    B = 2
    x = _draw((B, S, d), 20)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    rc = RA.init_kv_cache(B, 160, 2, 16, jnp.float32,
                          ring_window=cfg.window if local else None)
    tc = TA.init_kv_cache(B, 160, 2, 16, torch.float32,
                          ring_window=cfg.window if local else None,
                          device="cpu")
    want_xla, wc = jax.jit(partial(RA.attention_prefill, ref_cfg,
                                   local=local))(
        rp, jnp.asarray(x), jnp.asarray(pos), cache=rc)
    want_pl, _ = jax.jit(partial(RA.attention_prefill, ref_cfg, local=local,
                                 kernel_impl="pallas"))(
        rp, jnp.asarray(x), jnp.asarray(pos), cache=rc)
    n = b2.launches
    got, gc = TA.attention_prefill(cfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), local=local,
                                   cache=tc, kernel_impl="pallas")
    assert b2.launches == n
    _close(got, want_xla, REL["float32"])
    _close(got, want_pl, REL["float32"])
    for key in ("k", "v"):
        _close(gc[key], wc[key], REL["float32"])
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))

    xd = _draw((B, 1, d), 21)
    dpos = np.full((B,), S, np.int32)
    want, _ = jax.jit(partial(RA.attention_decode, ref_cfg, local=local))(
        rp, jnp.asarray(xd), jnp.asarray(dpos), wc)
    got, _ = TA.attention_decode(cfg, tp, torch.from_numpy(xd),
                                 torch.from_numpy(dpos), gc, local=local)
    _close(got, want, REL["float32"])


NONCAUSAL = dict(n_heads=4, n_kv_heads=2, head_dim=16, causal=False)


def _noncausal_prefill(S, kernel_impl_ref):
    ref_cfg, cfg, d, rp, tp = _layer(NONCAUSAL, seed=1)
    x = _draw((1, S, d), 22)
    pos = np.arange(S, dtype=np.int32)[None]
    want, _ = RA.attention_prefill(ref_cfg, rp, jnp.asarray(x),
                                   jnp.asarray(pos), local=False,
                                   kernel_impl=kernel_impl_ref)
    got, _ = TA.attention_prefill(cfg, tp, torch.from_numpy(x),
                                  torch.from_numpy(pos), local=False,
                                  kernel_impl="pallas")
    return got, want


def test_noncausal_prefill_pallas_matches_reference_xla_at_ragged_s():
    got, want = _noncausal_prefill(200, "xla")
    _close(got, want, REL["float32"])


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP C-ref1: the reference's Pallas wrapper zero-pads S=200 to 256 "
    "and the kernel lets non-causal queries attend to the padding; the "
    "port's B2 masks keys past the true length"))
def test_noncausal_prefill_pallas_matches_reference_pallas_at_ragged_s():
    got, want = _noncausal_prefill(200, "pallas")
    _close(got, want, REL["float32"])


def test_attention_prefill_rejects_unknown_kernel_impl():
    _, cfg, d, _, tp = _layer(LAYERS["qwen2"])
    x = torch.zeros(1, 4, d)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="kernel_impl"):
        TA.attention_prefill(cfg, tp, x, pos, local=False, kernel_impl="tc")
    with pytest.raises(ValueError, match="continuation"):
        TA.attention_prefill(cfg, tp, x, pos, local=False, continuation=True)


def test_attention_decode_refuses_a_negative_position():
    """kv_len would be 0 there, where B1 departs from the reference."""
    _, cfg, d, _, tp = _layer(LAYERS["qwen2"])
    cache = TA.init_kv_cache(2, 16, 2, 16, torch.float32, device="cpu")
    with pytest.raises(RuntimeError):
        TA.attention_decode(cfg, tp, torch.zeros(2, 1, d),
                            torch.tensor([3, -1], dtype=torch.int32), cache,
                            local=False)
