"""Parameter-definition tree of the unified LM and its parameter counts.

The shape half of the reference's ``models/model``: ``embed -> [segments
of layers] -> final_norm -> unembed`` as a nested dict of :class:`PDef`
leaves under the reference's paths (``seg0/b0/attn/wq``, ...).  The
forwards (train, prefill, decode) and caches are ROADMAP A10.
"""

from __future__ import annotations

import numpy as np

from .attention import attn_defs
from .config import BlockSpec, ModelConfig, segment_layers
from .layers import mlp_defs
from .mla import mla_defs
from .moe import moe_defs
from .params import PDef, _walk
from .rglru import rglru_defs
from .ssm import ssm_defs

__all__ = ["model_defs", "param_count", "active_param_count"]


# ------------------------------------------------------------------ norms


def _norm_defs(cfg: ModelConfig, d: int) -> dict:
    if cfg.norm == "layernorm":
        return {
            "scale": PDef((d,), ("embed",), "ones"),
            "bias": PDef((d,), ("embed",), "zeros"),
        }
    return {"scale": PDef((d,), ("embed",), "zeros")}  # rmsnorm (1 + scale)


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
