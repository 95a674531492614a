"""Multi-head Latent Attention parameter shapes (the forwards are ROADMAP A10)."""

from __future__ import annotations

import numpy as np

from .config import MLAConfig
from .params import PDef

__all__ = ["mla_defs"]


def mla_defs(cfg: MLAConfig, d_model: int) -> dict:
    H = cfg.n_heads
    s_q = 1.0 / np.sqrt(cfg.q_lora_rank)
    s_kv = 1.0 / np.sqrt(cfg.kv_lora_rank)
    s_o = 1.0 / np.sqrt(H * cfg.v_head_dim)
    return {
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
