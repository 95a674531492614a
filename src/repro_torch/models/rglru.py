"""RG-LRU recurrent block parameter shapes (the forwards are ROADMAP A10)."""

from __future__ import annotations

from .config import RGLRUConfig
from .params import PDef

__all__ = ["rglru_defs"]


def rglru_defs(cfg: RGLRUConfig, d_model: int) -> dict:
    W = cfg.width or d_model
    return {
        "w_main": PDef((d_model, W), ("embed", "lru")),
        "w_side": PDef((d_model, W), ("embed", "lru")),
        "conv_w": PDef((cfg.conv_width, W), ("conv", "lru"), scale=0.5),
        "conv_b": PDef((W,), ("lru",), "zeros"),
        "w_a": PDef((W, W), ("lru", None), scale=0.02),
        "b_a": PDef((W,), ("lru",), "const:-1.0"),
        "w_i": PDef((W, W), ("lru", None), scale=0.02),
        "b_i": PDef((W,), ("lru",), "zeros"),
        "lam": PDef((W,), ("lru",), "const:2.0"),  # sigmoid(2) ~ .88 decay
        "w_out": PDef((W, d_model), ("lru", "embed")),
    }
