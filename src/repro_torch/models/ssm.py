"""Mamba-2 SSD (state-space duality) block.

The reference's ``models/ssm``: a full-sequence forward whose chunk loop
is the SSD chunk scan (``kernels.ssd_scan``: the CUDA kernel on the card,
its plain version on the CPU), and the O(1) decode recurrence
h <- a h + dt * B x with a depthwise-conv state cache.

Layout: d_inner = expand * d_model, heads H = d_inner / head_dim (P),
state N per head; scalar A per head (Mamba-2's SSD restriction).

The casts are the reference's, in the same places, except the two inside
its chunk loop (``w`` and ``y_inter`` rounded to x's dtype): the scan
accumulates in f32 and rounds y once, so in bf16 the port differs from
the reference by those two roundings.  As in the reference, the forward
writes the final state into the cache but starts from a zero state and
never reads the cache's (ROADMAP C-ref4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..compat import resolve_device
from ..kernels.ssd_scan.ops import ssd_scan
from .config import SSMConfig
from .params import PDef

__all__ = ["ssm_defs", "ssm_forward", "ssm_decode", "init_ssm_cache"]


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


def init_ssm_cache(cfg: SSMConfig, d_model: int, batch: int, dtype,
                   device=None):
    device = resolve_device(device)
    d_in, H = _dims(cfg, d_model)
    N = cfg.d_state
    conv_dim = d_in + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, cfg.head_dim, N), dtype=torch.float32,
                           device=device),
    }


def _split(cfg: SSMConfig, d_model: int, zxbcdt):
    d_in, H = _dims(cfg, d_model)
    N = cfg.d_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : 2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N :]
    return z, xbc, dt


def _silu(x):
    return x * torch.sigmoid(x)  # jax.nn.silu, one op at a time


def _gated_norm(x, z, scale, eps=1e-6):
    x = x * _silu(z)
    var = x.float().square().mean(dim=-1, keepdim=True)
    out = x.float() * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def ssm_forward(cfg: SSMConfig, p, x, *, cache=None, initial_state=None):
    """Full-sequence SSD. x (B,S,d_model) -> (B,S,d_model).

    If ``cache`` is given, the final (conv, ssm) states are written to it
    (prefill for subsequent decode).
    """
    B, S, d_model = x.shape
    d_in, H = _dims(cfg, d_model)
    N, P = cfg.d_state, cfg.head_dim
    Q = min(cfg.chunk, S)
    if S % Q:
        raise ValueError(f"SSD needs seq divisible by chunk ({S} % {Q})")

    zxbcdt = x @ p["w_in"].to(x.dtype)
    z, xbc, dt = _split(cfg, d_model, zxbcdt)

    # depthwise causal conv over (x, B, C)
    pad = cfg.conv_width - 1
    if cache is not None:
        xbc_pad = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    else:
        xbc_pad = F.pad(xbc, (0, 0, pad, 0))
    conv_w = p["conv_w"].to(x.dtype)
    xbc_c = sum(
        xbc_pad[:, i : i + S] * conv_w[i][None, None, :]
        for i in range(cfg.conv_width)
    ) + p["conv_b"].to(x.dtype)
    xbc_c = _silu(xbc_c)

    xs = xbc_c[..., :d_in].reshape(B, S, H, P)
    Bm = xbc_c[..., d_in : d_in + N]  # (B,S,N) single group
    Cm = xbc_c[..., d_in + N :]  # (B,S,N)

    A = -torch.exp(p["A_log"].float())  # (H,)
    delta = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    # discretise: a_t = exp(delta * A); input scaled by delta
    log_a = delta * A[None, None, :]  # (B,S,H) negative
    xs_dt = xs * delta.to(xs.dtype)[..., None]

    y, state = ssd_scan(
        xs_dt.contiguous(), Bm.contiguous(), Cm.contiguous(),
        log_a.float().contiguous(),
        initial_state=(None if initial_state is None
                       else initial_state.float().contiguous()))
    y = y + xs * p["D"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["w_out"].to(x.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {
            "conv": xbc[:, S - (cfg.conv_width - 1):, :].to(
                cache["conv"].dtype
            ),
            "ssm": state,
        }
    return out, new_cache


def ssm_decode(cfg: SSMConfig, p, x, cache):
    """Single-token recurrence. x (B,1,d_model)."""
    B, _, d_model = x.shape
    d_in, H = _dims(cfg, d_model)
    N, P = cfg.d_state, cfg.head_dim
    zxbcdt = x @ p["w_in"].to(x.dtype)
    z, xbc, dt = _split(cfg, d_model, zxbcdt)
    xbc = xbc[:, 0]  # (B, conv_dim)

    # conv cache: window of last conv_width-1 inputs
    conv_w = p["conv_w"].to(x.dtype)
    hist = cache["conv"].to(x.dtype)  # (B, w-1, conv_dim)
    full = torch.cat([hist, xbc[:, None, :]], dim=1)  # (B,w,conv)
    xbc_c = torch.einsum("bwc,wc->bc", full, conv_w) + p["conv_b"].to(x.dtype)
    xbc_c = _silu(xbc_c)
    new_conv = full[:, 1:, :].to(cache["conv"].dtype)

    xs = xbc_c[..., :d_in].reshape(B, H, P)
    Bm = xbc_c[..., d_in : d_in + N]
    Cm = xbc_c[..., d_in + N :]
    A = -torch.exp(p["A_log"].float())
    delta = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    a = torch.exp(delta * A[None, :])  # (B,H)
    state = cache["ssm"] * a[:, :, None, None] + torch.einsum(
        "bn,bhp,bh->bhpn", Bm.float(), xs.float(), delta,
    )
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state).to(x.dtype)
    y = y + xs * p["D"].to(xs.dtype)[None, :, None]
    y = y.reshape(B, 1, d_in)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["w_out"].to(x.dtype)
    return out, {"conv": new_conv, "ssm": state}
