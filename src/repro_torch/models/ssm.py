"""Mamba-2 SSD parameter shapes (the forwards are ROADMAP A11)."""

from __future__ import annotations

from .config import SSMConfig
from .params import PDef

__all__ = ["ssm_defs"]


def _dims(cfg: SSMConfig, d_model: int):
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    return d_in, H


def ssm_defs(cfg: SSMConfig, d_model: int) -> dict:
    d_in, H = _dims(cfg, d_model)
    N = cfg.d_state
    conv_dim = d_in + 2 * N  # conv over (x, B, C) as in mamba2
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": PDef(
            (d_model, 2 * d_in + 2 * N + H), ("embed", "ff")
        ),
        "conv_w": PDef((cfg.conv_width, conv_dim), ("conv", "ff"), scale=0.5),
        "conv_b": PDef((conv_dim,), ("ff",), "zeros"),
        "A_log": PDef((H,), ("heads",), "const:0.0"),
        "dt_bias": PDef((H,), ("heads",), "zeros"),
        "D": PDef((H,), ("heads",), "ones"),
        "norm_scale": PDef((d_in,), ("ff",), "zeros"),
        "w_out": PDef((d_in, d_model), ("ff", "embed")),
    }
