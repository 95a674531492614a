"""Common layers: norms, MLPs, softcap.  Rotary embeddings come with the
attention forwards (ROADMAP A10)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import PDef

__all__ = ["rmsnorm", "layernorm", "mlp_defs", "apply_mlp", "softcap"]


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- MLP


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


def apply_mlp(p: dict, x, act: str):
    # jax.nn.gelu is the tanh approximation by default
    if act in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        a = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        return (a * u) @ p["w_down"]
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]
