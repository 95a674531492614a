"""Attention parameter shapes (the forwards are ROADMAP A10)."""

from __future__ import annotations

import numpy as np

from .config import AttentionConfig
from .params import PDef

__all__ = ["attn_defs"]


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
