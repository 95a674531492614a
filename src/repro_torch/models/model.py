"""Unified model: composes the mixer/channel modules into a full LM.

A model is ``embed -> [segments of layers] -> final_norm -> unembed``, as
in the reference's ``models/model``: ``segment_layers`` compresses the
per-layer BlockSpec list into ``(superblock, repeat)`` segments, each
segment's parameters and caches are stacked with a leading ``repeat``
dim, and the forward loops over it in Python (the reference's
``lax.scan``).  Parameter trees keep the reference's leaf paths
(``seg0/b0/ssm/w_in``, ...).

Three entry points, matching the serving/training split of the paper:

* :func:`forward_train` -- teacher-forced logits over a full sequence
  (and :func:`loss_fn`, its cross entropy with the MTP head).
* :func:`forward_prefill` -- full/chunked prefill that writes caches and
  returns the last-position logits.
* :func:`forward_decode` -- one-token decode step over the caches.

Every mixer (``attn``/``attn_local``, ``mla``, ``rec``, ``ssm``) and
channel (``mlp``, ``moe``) runs.  Encoder-decoder (whisper) runs its
encoder over stub frame embeddings and feeds cross-attention KV to every
decoder block; prefix-LM (paligemma) prepends stub patch embeddings with
a bidirectional prefix mask.  The loop over layers is the reference's
``unroll=True`` form, whose semantics the port keeps where its scanned
form refuses a residual stream that changes dtype (bf16 activations
against f32 caches, ROADMAP C-ref5).  Training runs the same loop under
autograd, without caches; ``remat=True`` checkpoints each repeat of a
segment (``torch.utils.checkpoint``, plain recompute: the reference's
``jax.checkpoint`` with a saving policy, which changes memory and time,
never the numbers).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..compat import resolve_device
from .attention import _einsum, attention_decode, attention_prefill, \
    attn_defs, blockwise_attention, init_kv_cache
from .config import BlockSpec, ModelConfig, segment_layers
from .layers import apply_mlp, layernorm, mlp_defs, rmsnorm, softcap
from .mla import init_mla_cache, mla_decode, mla_defs, mla_prefill
from .moe import apply_moe, moe_defs
from .params import PDef, _walk, init_params, tree_map
from .rglru import init_rglru_cache, rglru_decode, rglru_defs, rglru_forward
from .ssm import init_ssm_cache, ssm_decode, ssm_defs, ssm_forward

__all__ = ["model_defs", "param_count", "active_param_count", "init_cache",
           "forward_train", "forward_prefill", "forward_decode", "loss_fn",
           "encoder_forward", "init_model"]


# ------------------------------------------------------------------ norms


def _norm_defs(cfg: ModelConfig, d: int) -> dict:
    if cfg.norm == "layernorm":
        return {
            "scale": PDef((d,), ("embed",), "ones"),
            "bias": PDef((d,), ("embed",), "zeros"),
        }
    return {"scale": PDef((d,), ("embed",), "zeros")}  # rmsnorm (1 + scale)


def _apply_norm(cfg: ModelConfig, p: dict, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ------------------------------------------------------------- block defs


def _block_defs(cfg: ModelConfig, spec: BlockSpec) -> dict:
    d = cfg.d_model
    defs: dict = {"ln1": _norm_defs(cfg, d)}
    if spec.mixer in ("attn", "attn_local"):
        defs["attn"] = attn_defs(cfg.attn, d)
    elif spec.mixer == "mla":
        defs["mla"] = mla_defs(cfg.mla, d)
    elif spec.mixer == "ssm":
        defs["ssm"] = ssm_defs(cfg.ssm, d)
    elif spec.mixer == "rec":
        defs["rec"] = rglru_defs(cfg.rglru, d)
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        defs["lnx"] = _norm_defs(cfg, d)
        defs["xattn"] = attn_defs(cfg.attn, d)
    if spec.channel == "mlp":
        defs["ln2"] = _norm_defs(cfg, d)
        defs["mlp"] = mlp_defs(d, cfg.d_ff, cfg.mlp_act)
    elif spec.channel == "moe":
        defs["ln2"] = _norm_defs(cfg, d)
        defs["moe"] = moe_defs(cfg.moe, d)
    return defs


def _stack_defs(defs: dict, rep: int) -> dict:
    out = {}
    for k, v in defs.items():
        out[k] = _stack_defs(v, rep) if isinstance(v, dict) else v.stacked(rep)
    return out


def model_defs(cfg: ModelConfig) -> dict:
    """Full parameter-definition tree (PDef leaves)."""
    d, V = cfg.d_model, cfg.vocab_size
    defs: dict = {
        "embed": PDef((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": _norm_defs(cfg, d),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = PDef((d, V), ("embed", "vocab"))
    if cfg.attn is not None and not cfg.attn.rope:
        # learned decoder positions (whisper-style)
        defs["pos_embed"] = PDef((cfg.max_seq_len, d), (None, "embed"),
                                 scale=0.02)
    segs = segment_layers(cfg.block_specs())
    for si, (block, rep) in enumerate(segs):
        seg = {}
        for bi, spec in enumerate(block):
            seg[f"b{bi}"] = _stack_defs(_block_defs(cfg, spec), rep)
        defs[f"seg{si}"] = seg
    if cfg.encoder is not None:
        e = cfg.encoder
        enc_block = {
            "ln1": _norm_defs(cfg, e.d_model),
            "attn": attn_defs(cfg.attn.__class__(
                n_heads=e.n_heads, n_kv_heads=e.n_heads,
                head_dim=e.d_model // e.n_heads, rope=False, causal=False,
            ), e.d_model),
            "ln2": _norm_defs(cfg, e.d_model),
            "mlp": mlp_defs(e.d_model, e.d_ff, "gelu"),
        }
        defs["encoder"] = {
            "pos": PDef((e.n_frames, e.d_model), ("frames", "embed"),
                        scale=0.02),
            "layers": _stack_defs(enc_block, e.n_layers),
            "final_norm": _norm_defs(cfg, e.d_model),
        }
    if cfg.mtp:
        defs["mtp"] = {
            "norm": _norm_defs(cfg, d),
            "proj": PDef((2 * d, d), ("ff", "embed")),
        }
    return defs


# ------------------------------------------------------------------ caches


def _block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, max_len: int,
                 dtype, device):
    if spec.mixer in ("attn", "attn_local"):
        ring = cfg.attn.window if spec.mixer == "attn_local" else None
        c = init_kv_cache(batch, max_len, cfg.attn.n_kv_heads,
                          cfg.attn.head_dim, dtype, ring_window=ring,
                          quant=cfg.kv_quant, device=device)
    elif spec.mixer == "mla":
        c = init_mla_cache(cfg.mla, batch, max_len, dtype,
                           quant=cfg.kv_quant, device=device)
    elif spec.mixer == "ssm":
        c = init_ssm_cache(cfg.ssm, cfg.d_model, batch, dtype, device)
    elif spec.mixer == "rec":
        c = init_rglru_cache(cfg.rglru, cfg.d_model, batch, dtype, device)
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        shape = (batch, cfg.encoder.n_frames, cfg.attn.n_kv_heads,
                 cfg.attn.head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Per-segment stacked cache tree (leading dim = segment repeat)."""
    device = resolve_device(device)
    out = []
    for block, rep in segment_layers(cfg.block_specs()):
        seg = {}
        for bi, spec in enumerate(block):
            c = _block_cache(cfg, spec, batch, max_len, dtype, device)
            seg[f"b{bi}"] = tree_map(
                lambda a: a[None].expand((rep,) + a.shape).clone(), c)
        out.append(seg)
    return out


# ------------------------------------------------------------- block apply


def _cross_attention(cfg: ModelConfig, p, x, xk, xv):
    """Decoder->encoder cross attention (no mask, no rope)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    out = blockwise_attention(
        q, xk, xv,
        q_positions=torch.arange(x.shape[1], device=x.device),
        k_positions=torch.arange(xk.shape[1], device=x.device),
        causal=False,
    )
    return _einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def _apply_block(cfg: ModelConfig, spec: BlockSpec, p, x, *, positions,
                 mode, cache, prefix_len=None, enc_out=None,
                 kernel_impl="xla", continuation=False):
    """One layer. mode: "train" | "prefill" | "decode".  "train" is
    "prefill" with no cache: attention runs :func:`blockwise_attention`
    (``kernel_impl="xla"``, the reference's training default), and no
    cache is written."""
    h = _apply_norm(cfg, p["ln1"], x)
    new_cache = dict(cache) if cache is not None else None
    if spec.mixer in ("attn", "attn_local"):
        local = spec.mixer == "attn_local"
        kv_keys = ("k", "v", "pos") + (
            ("k_s", "v_s") if cache is not None and "k_s" in cache else ())
        sub = ({k: cache[k] for k in kv_keys}
               if cache is not None else None)
        if mode == "decode":
            out, nc = attention_decode(cfg.attn, p["attn"], h, positions, sub,
                                       local=local)
        else:
            out, nc = attention_prefill(
                cfg.attn, p["attn"], h, positions, local=local, cache=sub,
                prefix_len=prefix_len, kernel_impl=kernel_impl,
                continuation=continuation)
    elif spec.mixer == "mla":
        mla_keys = ("c_kv", "k_rope") + (
            ("c_s", "r_s") if cache is not None and "c_s" in cache else ())
        sub = ({k: cache[k] for k in mla_keys}
               if cache is not None else None)
        if mode == "decode":
            out, nc = mla_decode(cfg.mla, p["mla"], h, positions, sub)
        else:
            out, nc = mla_prefill(cfg.mla, p["mla"], h, positions, cache=sub,
                                  continuation=continuation)
    elif spec.mixer in ("ssm", "rec"):
        # both ignore ``continuation``, as in the reference: rec starts
        # from the cache's conv and state, ssm from its conv and a zero
        # state (C-ref4)
        keys, fwd, dec, mcfg = (
            (("conv", "ssm"), ssm_forward, ssm_decode, cfg.ssm)
            if spec.mixer == "ssm" else
            (("conv", "h"), rglru_forward, rglru_decode, cfg.rglru))
        sub = ({k: cache[k] for k in keys} if cache is not None else None)
        if mode == "decode":
            out, nc = dec(mcfg, p[spec.mixer], h, sub)
        else:
            out, nc = fwd(mcfg, p[spec.mixer], h, cache=sub)
    else:
        raise ValueError(spec.mixer)
    if nc is not None:
        new_cache.update(nc)
    x = x + out

    if spec.cross_attn:
        hx = _apply_norm(cfg, p["lnx"], x)
        if mode == "decode":
            xk, xv = cache["xk"], cache["xv"]
        else:
            # project the encoder output once; persist it in the cache
            xk = _einsum("bsd,dhk->bshk", enc_out,
                         p["xattn"]["wk"].to(x.dtype))
            xv = _einsum("bsd,dhk->bshk", enc_out,
                         p["xattn"]["wv"].to(x.dtype))
            if new_cache is not None:
                new_cache["xk"], new_cache["xv"] = xk, xv
        x = x + _cross_attention(cfg, p["xattn"], hx, xk, xv)

    if spec.channel == "mlp":
        h = _apply_norm(cfg, p["ln2"], x)
        mp = tree_map(lambda a: a.to(x.dtype), p["mlp"])
        x = x + apply_mlp(mp, h, cfg.mlp_act)
    elif spec.channel == "moe":
        h = _apply_norm(cfg, p["ln2"], x)
        x = x + apply_moe(cfg.moe, p["moe"], h)
    return x, new_cache


# --------------------------------------------------------------- backbone


def _run_segments(cfg: ModelConfig, params, x, *, positions, mode, caches,
                  prefix_len=None, enc_out=None, kernel_impl="xla",
                  continuation=False, remat=False):
    segs = segment_layers(cfg.block_specs())
    if mode == "train" and caches is not None:
        raise ValueError("train mode takes no caches: it writes none")
    new_caches = [] if caches is not None else None
    for si, (block, rep) in enumerate(segs):
        seg_p = params[f"seg{si}"]
        # one copy of the segment's caches per call: the layers write
        # their slices of it in place, the caller's caches stay as they were
        seg_c = (tree_map(lambda a: a.clone(
            memory_format=torch.contiguous_format), caches[si])
            if caches is not None else None)
        for r in range(rep):  # the reference's lax.scan over the stack
            p_r = tree_map(lambda a: a[r], seg_p)
            c_r = tree_map(lambda a: a[r], seg_c) if seg_c is not None \
                else None

            # every name the body reads from the loop is bound here: a
            # checkpointed body reruns in the backward, after the loop
            def body(x, p_r=p_r, c_r=c_r, r=r, block=block, seg_c=seg_c):
                for bi, spec in enumerate(block):
                    x, c = _apply_block(
                        cfg, spec, p_r[f"b{bi}"], x, positions=positions,
                        mode=mode, cache=(c_r[f"b{bi}"] if c_r else None),
                        prefix_len=prefix_len, enc_out=enc_out,
                        kernel_impl=kernel_impl, continuation=continuation)
                    if c_r is not None:
                        # KV and latent leaves come back written in place;
                        # the recurrent mixers' small states and the
                        # cross-attention K/V come back new.  A new leaf
                        # keeps its own dtype, as in the reference's cache
                        # tree: the cross-attention K/V are in the
                        # activations' dtype whatever the cache's
                        for k, dst in c_r[f"b{bi}"].items():
                            if c[k] is dst:
                                continue
                            if c[k].dtype != dst.dtype:
                                stack = seg_c[f"b{bi}"]
                                stack[k] = stack[k].to(c[k].dtype)
                                dst = c_r[f"b{bi}"][k] = stack[k][r]
                            dst.copy_(c[k])
                return x

            # ``remat``: the reference's ``jax.checkpoint`` around the body,
            # as plain recompute
            x = (checkpoint(body, x, use_reentrant=False) if remat
                 else body(x))
        if new_caches is not None:
            new_caches.append(seg_c)
    return x, new_caches


def _logits(cfg: ModelConfig, params, x):
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T
    else:
        w = params["unembed"].to(x.dtype)
    logits = torch.einsum("bsd,dv->bsv", x, w)
    if cfg.logit_softcap is not None:
        logits = softcap(logits.float(), cfg.logit_softcap)
    return logits


def _scale_embed(cfg: ModelConfig, x):
    # the reference multiplies by a numpy float32 scalar, which promotes
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return x * float(np.sqrt(cfg.d_model).astype(np.float32))


def _act_dtype(cfg: ModelConfig, x):
    return x.to(torch.bfloat16) if cfg.param_dtype == "bfloat16" else x


def _embed(cfg: ModelConfig, params, tokens, positions, prefix_embeds):
    x = params["embed"][tokens.long()]
    if cfg.scale_embed:
        x = _scale_embed(cfg, x)
    if "pos_embed" in params:
        x = x + params["pos_embed"][positions.long()]
    x = _act_dtype(cfg, x)
    prefix_len = None
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        prefix_len = prefix_embeds.shape[1]
    return x, prefix_len


def encoder_forward(cfg: ModelConfig, params, frames):
    """Whisper-style encoder over stub frame embeddings (B, n_frames, d).

    Non-causal self-attention through :func:`blockwise_attention` (the
    reference's default ``kernel_impl``), never the prefill kernel."""
    e = cfg.encoder
    p = params["encoder"]
    x = frames + p["pos"].to(frames.dtype)[None]
    acfg = cfg.attn.__class__(
        n_heads=e.n_heads, n_kv_heads=e.n_heads,
        head_dim=e.d_model // e.n_heads, rope=False, causal=False)
    positions = torch.arange(e.n_frames, device=frames.device)[None]
    for r in range(e.n_layers):  # the reference's lax.scan over the stack
        lp = tree_map(lambda a: a[r], p["layers"])
        h = _apply_norm(cfg, lp["ln1"], x)
        out, _ = attention_prefill(acfg, lp["attn"], h, positions,
                                   local=False)
        x = x + out
        h = _apply_norm(cfg, lp["ln2"], x)
        mp = tree_map(lambda a: a.to(x.dtype), lp["mlp"])
        x = x + apply_mlp(mp, h, "gelu")
    return _apply_norm(cfg, p["final_norm"], x)


# ------------------------------------------------------------ entry points


def _encode(cfg: ModelConfig, params, enc_frames, what: str):
    if cfg.encoder is None:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its {what} "
                         f"needs enc_frames (B, {cfg.encoder.n_frames}, "
                         f"{cfg.encoder.d_model}), the encoder's frame "
                         f"embeddings")
    return encoder_forward(cfg, params, enc_frames)


def forward_train(cfg: ModelConfig, params, tokens, *, prefix_embeds=None,
                  enc_frames=None, remat=False):
    """Teacher-forced logits (B, S, V) and the final hidden states
    (B, S, d), the prefix dropped from both.  ``remat=True`` recomputes
    each repeat of a segment in the backward pass instead of keeping its
    activations."""
    B, S = tokens.shape
    enc_out = _encode(cfg, params, enc_frames, "forward")
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, prefix_len = _embed(cfg, params, tokens, positions, prefix_embeds)
    if prefix_len:
        positions = torch.arange(x.shape[1], device=tokens.device)[
            None].expand(B, x.shape[1])
    x, _ = _run_segments(cfg, params, x, positions=positions, mode="train",
                         caches=None, prefix_len=prefix_len, enc_out=enc_out,
                         remat=remat)
    if prefix_len:
        x = x[:, prefix_len:]
    return _logits(cfg, params, x), x


def _nll(logits, lab, mask):
    """Masked mean of -log softmax(logits)[lab], the logits in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params, tokens, labels, *, prefix_embeds=None,
            enc_frames=None, remat=False):
    """Mean next-token cross entropy; labels < 0 are masked out.

    With ``cfg.mtp`` adds DeepSeek-V3-style multi-token prediction: a
    second head predicts token t+2 from [hidden_t ; embed(label_t)], with
    weight 0.3.
    """
    logits, hidden = forward_train(
        cfg, params, tokens, prefix_embeds=prefix_embeds,
        enc_frames=enc_frames, remat=remat)
    mask = (labels >= 0).float()
    lab = labels.clamp_min(0).long()
    loss = _nll(logits, lab, mask)
    if cfg.mtp:
        # predict labels shifted one more step (t+2 target from position t)
        emb_next = params["embed"][lab]
        if cfg.scale_embed:
            emb_next = _scale_embed(cfg, emb_next)
        h2 = torch.cat([hidden, emb_next.to(hidden.dtype)], dim=-1)
        h2 = h2 @ params["mtp"]["proj"].to(hidden.dtype)
        h2 = _apply_norm(cfg, params["mtp"]["norm"], h2)
        lab2 = torch.cat([lab[:, 1:], torch.zeros_like(lab[:, :1])], dim=1)
        mask2 = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
        loss = loss + 0.3 * _nll(_logits(cfg, params, h2), lab2, mask2)
    return loss


def forward_prefill(cfg: ModelConfig, params, tokens, positions, caches, *,
                    prefix_embeds=None, enc_frames=None, kernel_impl="xla",
                    continuation=False):
    """Prefill a chunk; returns (last-position logits, new caches).

    positions: (B, S) absolute positions of ``tokens`` (supports chunked /
    continued prefill).  ``prefix_embeds`` (B, P, d): stub patch
    embeddings prepended to the chunk, attended bidirectionally, with the
    tokens' positions shifted by P.  ``enc_frames`` (B, n_frames, d): the
    encoder's stub frame embeddings, which an encoder-decoder config
    needs.  ``kernel_impl="pallas"`` runs whole-prompt attention through
    the prefill attention kernel (B2); ``continuation=True`` attends over
    the cached context.
    """
    enc_out = _encode(cfg, params, enc_frames, "prefill")
    x, prefix_len = _embed(cfg, params, tokens, positions, prefix_embeds)
    if prefix_len:
        B = tokens.shape[0]
        pre = torch.arange(prefix_len, dtype=positions.dtype,
                           device=positions.device)
        positions = torch.cat([pre[None].expand(B, prefix_len),
                               positions + prefix_len], dim=1)
    x, new_caches = _run_segments(
        cfg, params, x, positions=positions, mode="prefill", caches=caches,
        prefix_len=prefix_len, enc_out=enc_out, kernel_impl=kernel_impl,
        continuation=continuation)
    return _logits(cfg, params, x[:, -1:]), new_caches


def forward_decode(cfg: ModelConfig, params, tokens, positions, caches):
    """One-token decode. tokens (B, 1); positions (B,) current index."""
    x, _ = _embed(cfg, params, tokens, positions[:, None], None)
    x, new_caches = _run_segments(cfg, params, x, positions=positions,
                                  mode="decode", caches=caches)
    return _logits(cfg, params, x), new_caches


def init_model(cfg: ModelConfig, generator: torch.Generator,
               dtype=torch.float32, device=None):
    return init_params(model_defs(cfg), generator, dtype, device)


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _walk(model_defs(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k+shared experts only)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    moe_layer = moe_defs(cfg.moe, cfg.d_model)
    routed = sum(
        int(np.prod(d.shape)) for path, d in _walk(moe_layer)
        if path[0] in ("w_gate", "w_up", "w_down"))
    n_moe_layers = sum(
        1 for s in cfg.block_specs() if s.channel == "moe")
    active_frac = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - n_moe_layers * routed * (1 - active_frac))
