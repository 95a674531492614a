"""Dense MLP parameter shapes (the forwards are ROADMAP A10)."""

from __future__ import annotations

from .params import PDef

__all__ = ["mlp_defs"]


def mlp_defs(d_model: int, d_ff: int, act: str) -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": PDef((d_model, d_ff), ("embed", "ff")),
            "w_up": PDef((d_model, d_ff), ("embed", "ff")),
            "w_down": PDef((d_ff, d_model), ("ff", "embed")),
        }
    return {  # plain gelu MLP (whisper)
        "w_up": PDef((d_model, d_ff), ("embed", "ff")),
        "b_up": PDef((d_ff,), ("ff",), "zeros"),
        "w_down": PDef((d_ff, d_model), ("ff", "embed")),
        "b_down": PDef((d_model,), ("embed",), "zeros"),
    }
