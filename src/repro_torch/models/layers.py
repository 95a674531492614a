"""Common layers: norms, MLPs, rotary embeddings, softcap."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .params import PDef

__all__ = ["rmsnorm", "layernorm", "mlp_defs", "apply_mlp", "rope_table",
           "apply_rope", "softcap"]


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


# ---------------------------------------------------------------- RoPE


@functools.lru_cache(maxsize=64)
def _rope_freqs(dim: int, theta: float, device: torch.device, yarn=None):
    """The reference's numpy f32 frequency table, on ``device`` once (a
    host-to-device copy in every layer would wait on the card).  ``yarn``
    (a ``YaRNConfig``): DeepSeek-V3's ``precompute_freqs_cis`` stretch,
    f / factor below the band [floor(corr(beta_fast)),
    ceil(corr(beta_slow))] of indices, f above it, a linear ramp between,
    where corr(r) = dim ln(original_max_len / (2 pi r)) / (2 ln theta)."""
    freqs = 1.0 / (
        theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    )
    if yarn is not None:
        def corr(rot):
            return dim * np.log(yarn.original_max_len / (rot * 2 * np.pi)) \
                / (2 * np.log(theta))

        lo = max(int(np.floor(corr(yarn.beta_fast))), 0)
        hi = min(int(np.ceil(corr(yarn.beta_slow))), dim - 1)
        ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - lo)
                       / max(hi - lo, 1e-3), 0, 1)
        freqs = freqs / np.float32(yarn.factor) * ramp + freqs * (1 - ramp)
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def rope_table(positions, dim: int, theta: float, yarn=None):
    """positions (...,) -> (sin, cos) of shape (..., dim//2), f32."""
    ang = positions[..., None].float() * _rope_freqs(dim, theta,
                                                     positions.device, yarn)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x (..., S, H, D); sin/cos (..., S, D/2) broadcast over heads.
    Rotates in f32 and casts back to x's dtype."""
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].float()
    xf2 = x[..., d2:].float()
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(
        x.dtype)
