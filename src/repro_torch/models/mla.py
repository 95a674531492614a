"""Multi-head Latent Attention (DeepSeek-V2/V3).

The reference's ``models/mla``: the KV cache stores only the compressed
latent c_kv (rank r) plus the shared RoPE key -- (r + d_rope) per token
per layer instead of 2*KV*D.  Decode uses the *absorbed* formulation:
queries are projected into latent space (q_nope @ W_uk) so scores are
taken directly against the latent cache, and the attention output stays
in latent space until the per-head W_uv/W_o projection.

DeepSeek-V3's parts are switched on by the config: ``latent_norms``
RMSNorms the query latent before W_uq and the KV latent before it is
cached (the cache holds the normed latent, as the published ``kv_norm``
does); ``yarn`` stretches the rotary frequencies and multiplies the
softmax scale by mscale^2 (:func:`_softmax_scale`), on the whole prefill,
the continuation chunk and the decode alike.

Scores and softmax run in f32 (the reference's
``preferred_element_type=jnp.float32``: both operands widened before the
contraction), the probabilities are cast back to the activations' dtype,
and every other contraction promotes its operands as ``jnp.einsum`` does
(bf16 activations against an f32 cache read in f32).  As in
``models.attention``, the cache writers write into the cache they are
given.

The decode and the continuation chunk attend over the latent cache
through :func:`_attend`: B4 (``kernels/mla_attention``) where the cache
holds latents in the queries' dtype, bf16 -- on the card the kernel, on
the CPU its plain version -- and that plain version itself for int8
latents and f32 caches.  The whole-prompt prefill (and with it training)
runs the plain version alone, one block of queries at a time over the
keys up to the block's last.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compat import resolve_device
from ..kernels.mla_attention.ops import mla_attention, mla_attention_plain
from .attention import _dequantize_kv, _einsum, _quantize_kv, _scatter
from .config import MLAConfig
from .layers import apply_rope, rmsnorm, rope_table
from .params import PDef

__all__ = ["mla_defs", "mla_prefill", "mla_decode", "init_mla_cache"]


def mla_defs(cfg: MLAConfig, d_model: int) -> dict:
    H = cfg.n_heads
    s_q = 1.0 / np.sqrt(cfg.q_lora_rank)
    s_kv = 1.0 / np.sqrt(cfg.kv_lora_rank)
    s_o = 1.0 / np.sqrt(H * cfg.v_head_dim)
    defs = {
        "w_dq": PDef((d_model, cfg.q_lora_rank), ("embed", "q_lora")),
        "w_uq": PDef(
            (cfg.q_lora_rank, H, cfg.qk_nope_dim + cfg.qk_rope_dim),
            ("q_lora", "heads", None), scale=s_q,
        ),
        "w_dkv": PDef((d_model, cfg.kv_lora_rank), ("embed", "kv_lora")),
        "w_kr": PDef((d_model, cfg.qk_rope_dim), ("embed", None)),
        "w_uk": PDef(
            (cfg.kv_lora_rank, H, cfg.qk_nope_dim), ("kv_lora", "heads", None),
            scale=s_kv,
        ),
        "w_uv": PDef(
            (cfg.kv_lora_rank, H, cfg.v_head_dim), ("kv_lora", "heads", None),
            scale=s_kv,
        ),
        "wo": PDef((H, cfg.v_head_dim, d_model), ("heads", None, "embed"),
                   scale=s_o),
    }
    if cfg.latent_norms:  # RMSNorm scales, (1 + scale)
        defs["q_norm"] = PDef((cfg.q_lora_rank,), ("q_lora",), "zeros")
        defs["kv_norm"] = PDef((cfg.kv_lora_rank,), ("kv_lora",), "zeros")
    return defs


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int, dtype,
                   quant=False, device=None):
    """Latent cache; ``quant=True`` stores int8 latents + per-token f16
    scales (the latent is already compressed -- int8 halves it again)."""
    device = resolve_device(device)
    dt = torch.int8 if quant else dtype
    cache = {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dt,
                              device=device),
    }
    if quant:
        cache["c_s"] = torch.zeros((batch, max_len), dtype=torch.float16,
                                   device=device)
        cache["r_s"] = torch.zeros((batch, max_len), dtype=torch.float16,
                                   device=device)
    return cache


def _mla_write(cache, b, pos2d, c_kv, k_rope):
    """``cache.at[b, pos2d].set(...)``, written into ``cache``."""
    if "c_s" in cache:
        qc, sc = _quantize_kv(c_kv)
        qr, sr = _quantize_kv(k_rope)
        return {
            "c_kv": _scatter(cache["c_kv"], b, pos2d, qc),
            "k_rope": _scatter(cache["k_rope"], b, pos2d, qr),
            "c_s": _scatter(cache["c_s"], b, pos2d, sc),
            "r_s": _scatter(cache["r_s"], b, pos2d, sr),
        }
    return {
        "c_kv": _scatter(cache["c_kv"], b, pos2d, c_kv),
        "k_rope": _scatter(cache["k_rope"], b, pos2d, k_rope),
    }


def _mla_read(cache, dtype):
    if "c_s" in cache:
        return (_dequantize_kv(cache["c_kv"], cache["c_s"], dtype),
                _dequantize_kv(cache["k_rope"], cache["r_s"], dtype))
    return cache["c_kv"], cache["k_rope"]


def _rope(cfg: MLAConfig, x, positions):
    sin, cos = rope_table(positions, cfg.qk_rope_dim, cfg.rope_theta,
                          cfg.yarn)
    return apply_rope(x, sin, cos)


def _softmax_scale(cfg: MLAConfig) -> float:
    """1/sqrt(qk head size), times YaRN's mscale^2 (DeepSeek-V3's
    ``MLA.softmax_scale``)."""
    scale = 1.0 / np.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    y = cfg.yarn
    if y is not None and y.factor > 1:
        if y.mscale != y.mscale_all_dim:  # would scale the rotary cos/sin
            raise ValueError("YaRN with mscale != mscale_all_dim")
        scale *= (0.1 * y.mscale_all_dim * np.log(y.factor) + 1.0) ** 2
    return scale


def _queries(cfg: MLAConfig, p, x, positions):
    q = torch.einsum("bsd,dr->bsr", x, p["w_dq"].to(x.dtype))
    if cfg.latent_norms:
        q = rmsnorm(q, p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", q, p["w_uq"].to(x.dtype))
    q_nope = q[..., : cfg.qk_nope_dim]
    q_rope = _rope(cfg, q[..., cfg.qk_nope_dim:], positions)
    return q_nope, q_rope


def _latents(cfg: MLAConfig, p, x, positions):
    """The token's cache entries: latent c_kv and the roped shared key."""
    c_kv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype))
    if cfg.latent_norms:
        c_kv = rmsnorm(c_kv, p["kv_norm"])
    k_rope = torch.einsum("bsd,dk->bsk", x, p["w_kr"].to(x.dtype))
    return c_kv, _rope(cfg, k_rope[:, :, None, :], positions)[:, :, 0, :]


def _attend(q_lat, q_rope, cache, positions, scale, x_dtype, kv_len=None):
    """ctx (B,Sq,H,r) of queries at ``positions`` (B,Sq) over the latent
    cache's first ``kv_len`` slots (all without it): B4 for latents in the
    queries' dtype, bf16; its plain version for int8 latents (read back in
    ``x_dtype``) and caches of another dtype."""
    if "c_s" not in cache and \
            q_lat.dtype == cache["c_kv"].dtype == torch.bfloat16:
        return mla_attention(q_lat.contiguous(), q_rope.contiguous(),
                             cache["c_kv"], cache["k_rope"], positions,
                             scale=scale, kv_len=kv_len)
    ckv, krope = _mla_read(cache, x_dtype)
    return mla_attention_plain(q_lat, q_rope, ckv, krope, positions,
                               scale=scale, kv_len=kv_len)


def _out(p, ctx, x_dtype, eq_uv, eq_o):
    o = _einsum(eq_uv, ctx, p["w_uv"].to(x_dtype))
    return _einsum(eq_o, o, p["wo"].to(x_dtype))


def mla_prefill(cfg: MLAConfig, p, x, positions, cache=None, block_q=512,
                continuation=False, kv_len=None):
    """Full-sequence MLA (causal); writes the latent cache in place.

    ``continuation=True``: chunked-prefill semantics -- the chunk's latents
    are merged into the cache first and queries attend over the cached
    context (absolute positions assumed uniform across batch rows).
    ``kv_len`` (a host int, above every query's position) cuts that
    context to the cache's first ``kv_len`` slots: the keys past it are
    masked for every query, so the scores stop there.  Otherwise
    queries attend over the chunk's own latents in blocks of
    ``block_q``, each restricted statically to the keys at or before its
    last query.
    """
    B, S, _ = x.shape
    q_nope, q_rope = _queries(cfg, p, x, positions)
    c_kv, k_rope = _latents(cfg, p, x, positions)

    new_cache = None
    if cache is not None:
        b = torch.arange(B, device=x.device)[:, None]
        pos2d = positions if positions.dim() > 1 else \
            positions[None, :].expand(B, -1)
        new_cache = _mla_write(cache, b, pos2d.long(), c_kv, k_rope)

    # absorbed scores: q_lat = q_nope @ W_uk  -> (B,S,H,r)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(x.dtype))
    scale = _softmax_scale(cfg)
    if continuation:
        if new_cache is None:
            raise ValueError("continuation needs a cache")
        qpos = positions[0] if positions.dim() > 1 else positions
        ctx = _attend(q_lat, q_rope, new_cache, qpos[None].expand(B, -1),
                      scale, x.dtype, kv_len)
    else:
        outs = []
        block_q = min(block_q, S)
        for s0 in range(0, S, block_q):
            s1 = min(S, s0 + block_q)  # causal static restriction: keys < s1
            qpos = torch.arange(s0, s1, device=x.device)[None].expand(B, -1)
            outs.append(mla_attention_plain(
                q_lat[:, s0:s1], q_rope[:, s0:s1], c_kv, k_rope, qpos,
                scale=scale, kv_len=s1))
        ctx = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    out = _out(p, ctx, x.dtype, "bqhr,rhv->bqhv", "bqhv,hvd->bqd")
    return out, new_cache


def mla_decode(cfg: MLAConfig, p, x, positions, cache):
    """One-token absorbed decode over the latent cache; positions (B,).
    Writes the token's latents into ``cache`` and returns it."""
    B = x.shape[0]
    pos = positions[:, None]
    q_nope, q_rope = _queries(cfg, p, x, pos)
    c_new, k_new = _latents(cfg, p, x, pos)
    b = torch.arange(B, device=x.device)[:, None]
    cache = _mla_write(cache, b, pos.long(), c_new, k_new)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(x.dtype))
    ctx = _attend(q_lat, q_rope, cache, pos, _softmax_scale(cfg),
                  x.dtype)[:, 0]
    out = _out(p, ctx, x.dtype, "bhr,rhv->bhv", "bhv,hvd->bd")[:, None, :]
    return out, cache
