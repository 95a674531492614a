"""Attention: GQA with RoPE, sliding-window, softcap, prefix-LM; KV caches.

The reference's ``models/attention``, with its names and signatures:

* Prefill attention is *blockwise* over query blocks with a static Python
  loop; causal/local blocks slice the KV range they can attend to.  With
  ``kernel_impl="pallas"`` a whole-prompt prefill runs the prefill
  attention kernel instead (B2, ``kernels.prefill_attention``), as the
  reference's does.  A continuation chunk over a plain cache in its own
  dtype runs B2 with a query offset and a key length whatever
  ``kernel_impl`` says: it
  computes the reference's blockwise chunk without its score tensor over
  the whole cache (:func:`attention_prefill`).
* Decode (Sq == 1) runs the decode attention kernel (B1,
  ``kernels.decode_attention``) on every call: it computes the
  reference's decode function, so on the CPU its plain version is this
  layer's decode.
* Sliding-window ("local") layers keep a **ring buffer** cache of size
  ``window``; ``quant=True`` caches hold int8 K/V with f16 scales.
* The cache writers write into the cache they are given, where the
  reference's return a new one.  No layer copies its cache.

``torch.einsum`` refuses mixed dtypes where ``jnp.einsum`` promotes, so
each contraction promotes its operands as JAX would (``_einsum``): bf16
queries against an f32 cache score in f32, and an f32 attention output
promotes the projection and then the residual stream to f32.  These are
the reference's semantics with ``unroll=True`` (its scanned layer loop
refuses the carry's change of dtype, ROADMAP C-ref5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..compat import resolve_device
from ..kernels.decode_attention import ops as dec_ops
from ..kernels.prefill_attention import ops as pf_ops
from ..telemetry import counters
from .config import AttentionConfig
from .layers import apply_rope, rope_table, softcap
from .params import PDef

__all__ = [
    "attn_defs",
    "blockwise_attention",
    "decode_attention",
    "attention_prefill",
    "attention_decode",
    "init_kv_cache",
]

_NEG = -2.0e9


def attn_defs(cfg: AttentionConfig, d_model: int) -> dict:
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_in = 1.0 / np.sqrt(d_model)   # fan-in of the (d -> heads) projections
    s_out = 1.0 / np.sqrt(H * D)    # fan-in of the output projection
    defs = {
        "wq": PDef((d_model, H, D), ("embed", "heads", None), scale=s_in),
        "wk": PDef((d_model, KV, D), ("embed", "kv_heads", None), scale=s_in),
        "wv": PDef((d_model, KV, D), ("embed", "kv_heads", None), scale=s_in),
        "wo": PDef((H, D, d_model), ("heads", None, "embed"), scale=s_out),
    }
    if cfg.qkv_bias:
        defs["bq"] = PDef((H, D), ("heads", None), "zeros")
        defs["bk"] = PDef((KV, D), ("kv_heads", None), "zeros")
        defs["bv"] = PDef((KV, D), ("kv_heads", None), "zeros")
    return defs


def _einsum(eq: str, a, b):
    """``jnp.einsum``'s promotion: both operands to their common type."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _block_mask(q_pos, k_pos, *, causal, window, prefix_len, kv_len,
                slot_idx=None):
    """q_pos (Bq,), k_pos (Bk,) absolute positions -> (B?, Bq, Bk) bool.

    ``slot_idx``: cache slot indices of the keys (differs from k_pos for
    ring caches); ``kv_len`` masks by slot index.  Negative k_pos marks
    empty cache slots.
    """
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=k_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    if prefix_len is not None:
        # prefix-LM: bidirectional over the first prefix_len positions
        m = m | (k_pos[None, :] < prefix_len)
    m &= (k_pos >= 0)[None, :]  # empty ring slots
    if kv_len is not None:
        # kv_len (B,) -> (B, Bq, Bk)
        si = slot_idx if slot_idx is not None else k_pos
        return m[None] & (si[None, None, :] < kv_len[:, None, None])
    return m


def blockwise_attention(
    q, k, v, *,
    q_positions, k_positions,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len=None,
    kv_len=None,
    attn_softcap: Optional[float] = None,
    block_q: int = 512,
):
    """q (B,Sq,H,D); k,v (B,Skv,KV,D) -> (B,Sq,H,D) in v's dtype.

    Static Python loop over query blocks; causal/local blocks statically
    slice the KV range they can attend to.  Scores and softmax in f32, P
    rounded to v's dtype before P·V, as in the reference.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(D)
    block_q = min(block_q, Sq)
    n_blocks = (Sq + block_q - 1) // block_q
    outs = []
    kp = k_positions
    for bi in range(n_blocks):
        s0 = bi * block_q
        s1 = min(Sq, s0 + block_q)
        qb = q[:, s0:s1]
        qp = q_positions[..., s0:s1]
        # static KV range restriction
        lo, hi = 0, Skv
        if causal and Sq == Skv and prefix_len is None and kv_len is None:
            hi = s1
            if window is not None:
                lo = max(0, s0 - (window - 1))
        kb, vb = k[:, lo:hi], v[:, lo:hi]
        kpb = kp[lo:hi]
        # scores: (B, KV, G, Bq, Skv'), f32
        qg = qb.reshape(B, s1 - s0, KV, G, D)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kb.float()) \
            * float(scale)
        if attn_softcap is not None:
            sc = softcap(sc, attn_softcap)
        m = _block_mask(
            qp if qp.dim() == 1 else qp[0],
            kpb,
            causal=causal, window=window, prefix_len=prefix_len,
            kv_len=kv_len,
            slot_idx=(torch.arange(lo, hi, device=kpb.device)
                      if kv_len is not None else None),
        )
        if m.dim() == 2:
            m = m[None, None, None]  # (1,1,1,Bq,Bk)
        else:
            m = m[:, None, None]  # (B,1,1,Bq,Bk)
        p = torch.softmax(sc.masked_fill(~m, _NEG), dim=-1)
        ob = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), vb)
        outs.append(ob.reshape(B, s1 - s0, H, D))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_attention(q, k_cache, v_cache, *, kv_len, k_positions=None,
                     window=None, attn_softcap=None, q_positions=None):
    """Single-token decode: q (B,1,H,D) over cache (B,S,KV,D); kv_len (B,).

    Runs B1 (``kernels.decode_attention``): the kernel on the card, its
    plain version on the CPU.  B1 takes one dtype, so q and the caches go
    in at their common type (q bf16 against an f32 cache: q is widened,
    losslessly); the output is in v's dtype, as the reference's.  As in
    the reference, the window applies only with both position arrays.
    B1 and the reference differ only at ``kv_len == 0`` (B1 gives zeros,
    the reference averages V), which callers must not pass.
    """
    if k_positions is None or q_positions is None:
        window = None
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    out = dec_ops.decode_attention(
        q.to(dt).contiguous(), k_cache.to(dt), v_cache.to(dt), kv_len,
        window=window, k_positions=k_positions, q_positions=q_positions,
        attn_softcap=attn_softcap)
    return out.to(v_cache.dtype)


# ------------------------------------------------------------------ caches


def init_kv_cache(batch, max_len, n_kv, head_dim, dtype, ring_window=None,
                  quant=False, device=None):
    """KV cache; ring-buffered when ``ring_window`` is set (local layers).

    ``quant=True`` stores K/V in int8 with per-(token, kv-head) fp16 scales
    (the scale overhead is 2/head_dim).  Quantisation happens in the cache
    writers; readers dequantise on load.
    """
    device = resolve_device(device)
    S = min(max_len, ring_window) if ring_window else max_len
    kv_dtype = torch.int8 if quant else dtype
    cache = {
        "k": torch.zeros((batch, S, n_kv, head_dim), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((batch, S, n_kv, head_dim), dtype=kv_dtype,
                         device=device),
        # absolute position of each slot (ring caches need it for masking)
        "pos": torch.full((batch, S), -1, dtype=torch.int32, device=device),
    }
    if quant:
        cache["k_s"] = torch.zeros((batch, S, n_kv), dtype=torch.float16,
                                   device=device)
        cache["v_s"] = torch.zeros((batch, S, n_kv), dtype=torch.float16,
                                   device=device)
    return cache


def _quantize_kv(x):
    """x (..., D) -> (int8 values, scale over the last axis)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale.to(torch.float16)


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale.float()[..., None]).to(dtype)


def _scatter(a, b, idx, vals):
    """``a.at[b, idx].set(vals)`` written into ``a``, ``vals`` cast to a's
    dtype."""
    a[b, idx] = vals.to(a.dtype)
    return a


def _write(cache, b, idx, k, v, positions):
    out = {"pos": _scatter(cache["pos"], b, idx, positions)}
    if "k_s" in cache:
        qk, sk = _quantize_kv(k)
        qv, sv = _quantize_kv(v)
        out["k"] = _scatter(cache["k"], b, idx, qk)
        out["v"] = _scatter(cache["v"], b, idx, qv)
        out["k_s"] = _scatter(cache["k_s"], b, idx, sk)
        out["v_s"] = _scatter(cache["v_s"], b, idx, sv)
    else:
        out["k"] = _scatter(cache["k"], b, idx, k)
        out["v"] = _scatter(cache["v"], b, idx, v)
    return out


def cache_write_prefill(cache, k, v, positions):
    """Write a full prefill chunk at positions (B,S) (assumed in range)
    into ``cache``; returns it.

    For ring caches only the last `ring` tokens land (modulo write); the
    inputs are sliced first so duplicate ring slots are never scattered.
    """
    S_cache = cache["k"].shape[1]
    if k.shape[1] > S_cache:
        k = k[:, -S_cache:]
        v = v[:, -S_cache:]
        positions = positions[:, -S_cache:]
    idx = (positions % S_cache).long()
    b = torch.arange(k.shape[0], device=k.device)[:, None]
    return _write(cache, b, idx, k, v, positions)


def cache_write_decode(cache, k, v, positions):
    """Write one token at positions (B,) into ``cache``; k,v (B,1,KV,D)."""
    S_cache = cache["k"].shape[1]
    idx = (positions % S_cache).long()[:, None]
    b = torch.arange(k.shape[0], device=k.device)[:, None]
    return _write(cache, b, idx, k, v, positions[:, None])


def cache_kv_arrays(cache, dtype):
    """Read (k, v) from a cache, dequantising if int8-quantised."""
    if "k_s" in cache:
        return (_dequantize_kv(cache["k"], cache["k_s"], dtype),
                _dequantize_kv(cache["v"], cache["v_s"], dtype))
    return cache["k"], cache["v"]


# ------------------------------------------------------------ full blocks


def _project_qkv(cfg: AttentionConfig, p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _chunk_on_b2(cache, q, window, prefix_len, kv_len) -> bool:
    """Whether a continuation chunk can run through B2: over a plain
    cache, where key slot i holds position i for every slot the chunk
    attends to, in the queries' dtype.  Not over a ring (a local layer's
    ``window``, or a chunk ending past the cache, as the host's
    ``kv_len`` says), nor over int8 K/V, nor under a prefix-LM mask,
    whose chunk rows are not consecutive positions (the prefix is
    prepended to every chunk), nor over a cache in another dtype than
    the queries', where the blockwise path rounds the softmax weights to
    the cache's dtype before P.V, as the reference does, and B2, which
    takes one dtype, would not."""
    return ("k_s" not in cache and window is None and prefix_len is None
            and kv_len <= cache["k"].shape[1]
            and q.dtype == cache["k"].dtype)


def attention_prefill(cfg: AttentionConfig, p, x, positions, *, local: bool,
                      cache=None, prefix_len=None, kernel_impl: str = "xla",
                      continuation: bool = False, kv_len=None):
    """Full-sequence attention; optionally writes the cache (in place).

    positions: (B, S) absolute positions.  With ``continuation=True`` the
    chunk is first merged into the cache and queries attend over the whole
    cached context (chunked-prefill semantics; assumes batch rows share the
    chunk layout and its positions are consecutive, which holds for the
    engine's one-request chunks).  Such a chunk needs ``kv_len``, a host
    int past every position of the chunk (the engine's chunk end).  Over
    a plain cache that it ends inside, the chunk runs through B2 with
    ``q_offset`` = its first position and ``kv_len`` = its last
    position + 1, both on the device: B2 masks by slot index as the
    blockwise path masks by the slots' positions, which are equal there
    (:func:`_chunk_on_b2`), and reads no key past the chunk's end.  Ring,
    int8 and prefix-LM caches, caches in another dtype than the queries',
    and chunks past the cache's end run :func:`blockwise_attention` over
    the whole cache.  While the profiler
    runs, each chunk counts by route in ``telemetry.counters``.  Without
    ``continuation``, ``kernel_impl="pallas"`` runs B2 over the chunk's
    own keys and ``"xla"`` (the default) :func:`blockwise_attention`.
    Returns (out, new_cache).
    """
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.rope:
        sin, cos = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    window = cfg.window if local else None
    new_cache = None
    if cache is not None:
        new_cache = cache_write_prefill(cache, k, v, positions)
    if continuation:
        if new_cache is None:
            raise ValueError("continuation needs a cache")
        if kv_len is None:
            raise ValueError("a continuation chunk needs kv_len, a host int "
                             "past its last position")
        S_cache = new_cache["k"].shape[1]
        # never past the host's kv_len: B2 is given the slots below it
        ends = torch.clamp(positions[:, -1] + 1, max=min(S_cache, kv_len))
        b2 = _chunk_on_b2(new_cache, q, window, prefix_len, kv_len)
        if counters.on():
            counters.chunk_attention(b2)
        if b2:
            # B2 reads no slot past kv_len: it gets the cache up to there
            # (a view at batch 1, the engine's chunk)
            kk, vv = (new_cache[n][:, :kv_len].contiguous()
                      for n in ("k", "v"))
            out = pf_ops.prefill_attention(
                q.contiguous(), kk, vv, causal=cfg.causal,
                attn_softcap=cfg.attn_softcap, q_offset=positions[:, 0],
                kv_len=ends)
        else:
            kk, vv = cache_kv_arrays(new_cache, v.dtype)
            out = blockwise_attention(
                q, kk, vv,
                q_positions=positions[0] if positions.dim() > 1
                else positions,
                k_positions=new_cache["pos"][0],
                causal=cfg.causal, window=window, prefix_len=prefix_len,
                kv_len=ends, attn_softcap=cfg.attn_softcap,
            )
    elif kernel_impl == "pallas":
        out = pf_ops.prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=cfg.causal,
            window=window, attn_softcap=cfg.attn_softcap,
            prefix_len=prefix_len,
        )
    elif kernel_impl == "xla":
        out = blockwise_attention(
            q, k, v,
            q_positions=positions[0] if positions.dim() > 1 else positions,
            k_positions=positions[0] if positions.dim() > 1 else positions,
            causal=cfg.causal, window=window, prefix_len=prefix_len,
            attn_softcap=cfg.attn_softcap,
        )
    else:
        raise ValueError(f"kernel_impl must be 'xla' or 'pallas', got "
                         f"{kernel_impl!r}")
    proj = _einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, new_cache


def attention_decode(cfg: AttentionConfig, p, x, positions, cache, *,
                     local: bool):
    """One-token decode; positions (B,) = current index; updates cache in
    place."""
    q, k, v = _project_qkv(cfg, p, x)  # (B,1,·,D)
    if cfg.rope:
        sin, cos = rope_table(positions[:, None], cfg.head_dim,
                              cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    cache = cache_write_decode(cache, k, v, positions)
    S_cache = cache["k"].shape[1]
    kv_len = torch.clamp(positions + 1, max=S_cache)
    # B1 departs from the reference at kv_len == 0: a negative position
    # would reach it (checked on the device, no host sync)
    torch._assert_async((kv_len > 0).all())
    kk, vv = cache_kv_arrays(cache, v.dtype)
    out = decode_attention(
        q, kk, vv, kv_len=kv_len,
        k_positions=cache["pos"], q_positions=positions,
        window=cfg.window if local else None,
        attn_softcap=cfg.attn_softcap,
    )
    proj = _einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, cache
