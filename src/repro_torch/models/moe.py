"""Mixture-of-Experts parameter shapes (the forwards are ROADMAP A10)."""

from __future__ import annotations

from .config import MoEConfig
from .params import PDef

__all__ = ["moe_defs"]


def moe_defs(cfg: MoEConfig, d_model: int) -> dict:
    E, F = cfg.n_experts, cfg.d_ff_expert
    defs = {
        "router": PDef((d_model, E), ("embed", "expert"), scale=0.02),
        "w_gate": PDef((E, d_model, F), ("expert", "embed", "expert_ff")),
        "w_up": PDef((E, d_model, F), ("expert", "embed", "expert_ff")),
        "w_down": PDef((E, F, d_model), ("expert", "expert_ff", "embed")),
    }
    if cfg.n_shared:
        defs["shared"] = {
            "w_gate": PDef((d_model, F * cfg.n_shared), ("embed", "ff")),
            "w_up": PDef((d_model, F * cfg.n_shared), ("embed", "ff")),
            "w_down": PDef((F * cfg.n_shared, d_model), ("ff", "embed")),
        }
    return defs
