"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Block structure (Griffin):  x -> [W_side -> GeLU]  and
[W_main -> causal conv1d(4) -> RG-LRU] -> elementwise product -> W_out.

RG-LRU:  r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
         a_t = exp(c * r_t * log(sigmoid(Lambda)))        (per channel)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference's ``models/rglru``.  Its sequence mode is
``jax.lax.associative_scan``, which has no kernel; here the same
log-depth scan is a Hillis-Steele scan over the sequence, ``log2(S)``
elementwise steps.  Decode is the O(1) recurrence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..compat import resolve_device
from .config import RGLRUConfig
from .params import PDef

__all__ = ["rglru_defs", "rglru_forward", "rglru_decode", "init_rglru_cache"]


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


def init_rglru_cache(cfg: RGLRUConfig, d_model: int, batch: int, dtype,
                     device=None):
    device = resolve_device(device)
    W = cfg.width or d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, W), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
    }


def _gates(cfg: RGLRUConfig, p, u):
    r = torch.sigmoid(u @ p["w_a"].to(u.dtype) + p["b_a"].to(u.dtype))
    i = torch.sigmoid(u @ p["w_i"].to(u.dtype) + p["b_i"].to(u.dtype))
    log_sig_lam = F.logsigmoid(p["lam"].float())
    log_a = cfg.c * r.float() * log_sig_lam  # (…, W), negative
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        i.float() * u.float()
    )
    return a, gated


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 (h_{-1} = 0): the reference's
    ``associative_scan`` of (a_l a_r, a_r b_l + b_r), as a Hillis-Steele
    scan in ``ceil(log2(S))`` elementwise steps."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru_forward(cfg: RGLRUConfig, p, x, *, cache=None):
    """x (B,S,d_model) -> (B,S,d_model); writes final state into cache."""
    B, S, _ = x.shape
    side = F.gelu(x @ p["w_side"].to(x.dtype), approximate="tanh")
    u = x @ p["w_main"].to(x.dtype)
    # causal depthwise conv
    pad = cfg.conv_width - 1
    up = F.pad(u, (0, 0, pad, 0))
    if cache is not None:
        up[:, :pad] = cache["conv"].to(u.dtype)
    cw = p["conv_w"].to(x.dtype)
    uc = sum(
        up[:, i : i + S] * cw[i][None, None, :] for i in range(cfg.conv_width)
    ) + p["conv_b"].to(x.dtype)

    a, gated = _gates(cfg, p, uc)
    h0 = cache["h"] if cache is not None else torch.zeros_like(gated[:, 0])
    # include initial state by folding it into the first input
    gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None], gated[:, 1:]],
                      dim=1)
    h = _linear_scan(a, gated)
    y = (h.to(x.dtype) * side) @ p["w_out"].to(x.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {
            "conv": u[:, S - pad :, :].to(cache["conv"].dtype),
            "h": h[:, -1],
        }
    return y, new_cache


def rglru_decode(cfg: RGLRUConfig, p, x, cache):
    """x (B,1,d_model); O(1) state update."""
    side = F.gelu(x[:, 0] @ p["w_side"].to(x.dtype), approximate="tanh")
    u = x[:, 0] @ p["w_main"].to(x.dtype)  # (B,W)
    hist = cache["conv"].to(x.dtype)
    full = torch.cat([hist, u[:, None, :]], dim=1)
    cw = p["conv_w"].to(x.dtype)
    uc = torch.einsum("bwc,wc->bc", full, cw) + p["conv_b"].to(x.dtype)
    a, gated = _gates(cfg, p, uc)
    h = a * cache["h"] + gated
    y = (h.to(x.dtype) * side) @ p["w_out"].to(x.dtype)
    return y[:, None, :], {"conv": full[:, 1:, :].to(cache["conv"].dtype),
                           "h": h}
