"""Mixture-of-Experts with capacity-based dispatch (GShard/Switch style).

The reference's ``models/moe``: token copies are sorted by expert id,
scattered into a dense (E, capacity, d) buffer (static shapes, batched
matmuls over the expert dim), then combined back with top-k gate weights.
Tokens beyond an expert's capacity are dropped (``capacity_factor``
controls slack), exactly the copies the reference drops: the sort is
stable, as ``jnp.argsort`` is.

The router is softmax top-k with optional gate renormalisation, as in
the reference, or DeepSeek-V3's published gate (``scoring="sigmoid"``,
:func:`_route`).  A layer may hold only some of the router's experts, as
one chip of an expert-parallel deployment does: it routes over all
``router_experts``, computes the part of the result its own experts give,
and sends every other copy to the spare row, as a dropped copy goes.
Shared experts are plain always-on MLPs added to the routed output.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..telemetry import counters
from .config import MoEConfig
from .params import PDef

__all__ = ["moe_defs", "apply_moe"]


def _router_width(cfg: MoEConfig) -> int:
    return cfg.router_experts or cfg.n_experts


def moe_defs(cfg: MoEConfig, d_model: int) -> dict:
    E, F_, R = cfg.n_experts, cfg.d_ff_expert, _router_width(cfg)
    defs = {
        "router": PDef((d_model, R), ("embed", "expert"), scale=0.02),
        "w_gate": PDef((E, d_model, F_), ("expert", "embed", "expert_ff")),
        "w_up": PDef((E, d_model, F_), ("expert", "embed", "expert_ff")),
        "w_down": PDef((E, F_, d_model), ("expert", "expert_ff", "embed")),
    }
    if cfg.scoring == "sigmoid":  # the selection bias
        defs["router_bias"] = PDef((R,), ("expert",), scale=0.05)
    if cfg.n_shared:
        defs["shared"] = {
            "w_gate": PDef((d_model, F_ * cfg.n_shared), ("embed", "ff")),
            "w_up": PDef((d_model, F_ * cfg.n_shared), ("embed", "ff")),
            "w_down": PDef((F_ * cfg.n_shared, d_model), ("ff", "embed")),
        }
    return defs


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(np.ceil(n_tokens * cfg.top_k / _router_width(cfg)
                      * cfg.capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def _route(cfg: MoEConfig, p: dict, xf):
    """(gate weights (T, k) f32, expert ids (T, k) over the router's
    width).

    ``softmax``: the top k of the router's softmax.  ``sigmoid``, the
    published DeepSeek-V3 gate (its ``inference/model.py``,
    ``Gate.forward``): scores s = sigmoid(x W) in f32; the selection adds
    the learned ``router_bias`` to them; with ``n_groups`` > 1 a group's score is the
    sum of its two best biased scores and only the ``topk_groups`` best
    groups stay; the top k biased scores choose the experts, whose weights
    are their unbiased s.  Either way the weights are renormalised to sum
    1 (``router_scale``) and multiplied by ``routed_scale``."""
    k = cfg.top_k
    if cfg.scoring == "softmax":
        logits = torch.einsum("td,de->te", xf, p["router"].to(xf.dtype))
        probs = torch.softmax(logits.float(), dim=-1)
        gate_w, idx = torch.topk(probs, k, dim=-1)  # (T,k)
    elif cfg.scoring == "sigmoid":
        s = torch.sigmoid(xf.float() @ p["router"].float())
        sel = s + p["router_bias"].float()
        if cfg.n_groups > 1:
            g = sel.view(sel.shape[0], cfg.n_groups, -1)
            best = g.topk(2, dim=-1).values.sum(-1)  # (T, groups)
            kept = best.topk(cfg.topk_groups, dim=-1).indices
            left = torch.ones_like(best, dtype=torch.bool).scatter_(
                1, kept, False)
            sel = g.masked_fill(left[..., None], float("-inf")).flatten(1)
        idx = torch.topk(sel, k, dim=-1).indices
        gate_w = s.gather(1, idx)
    else:
        raise ValueError(f"unknown router scoring {cfg.scoring!r}")
    if cfg.router_scale:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    if cfg.routed_scale != 1.0:
        gate_w = gate_w * cfg.routed_scale
    return gate_w, idx


def apply_moe(cfg: MoEConfig, p: dict, x):
    """x (B,S,d) -> (B,S,d). Static-shape capacity dispatch.

    The reference's ``.at[...].set(..., mode="drop")`` sends a dropped
    copy to the out-of-range expert row ``E``; here the ``keep`` mask
    sends it to a spare row ``E`` of the buffers, which is cut off before
    use, so no index wraps and nothing waits on the host.  A copy routed
    to an expert this layer does not hold goes there too.  The capacity
    is ``ceil(T k / router_experts x capacity_factor)``.  The combine
    is a scatter-add (``index_add_``; on the card its additions run in no
    fixed order).  ``cfg.dispatch_hint`` is a sharding constraint for a
    device mesh and has no counterpart on one card.
    """
    B, S, d = x.shape
    T = B * S
    k = cfg.top_k
    E = cfg.n_experts
    xf = x.reshape(T, d)
    dev = x.device

    gate_w, idx = _route(cfg, p, xf)

    # flatten token copies and sort by expert id
    eid = idx.reshape(-1)  # (T*k,)
    part = _router_width(cfg) != E or cfg.expert_offset != 0
    if part:  # experts not held here -> E, sorted last
        eid = eid - cfg.expert_offset
        eid = torch.where((eid >= 0) & (eid < E), eid, E)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    tok_s = order // k
    # start offset of each expert in the sorted list
    starts = torch.searchsorted(
        eid_s, torch.arange(E + int(part), device=dev), side="left")
    pos = torch.arange(T * k, device=dev) - starts[eid_s]
    cap = _capacity(cfg, T)
    keep = pos < cap
    if part:
        keep = keep & (eid_s < E)
    if counters.on():
        counters.moe_dispatch(keep.sum(), (eid_s < E).sum(), E * cap)
    e_idx = torch.where(keep, eid_s, E)  # dropped copies -> spare row E
    c_idx = torch.where(keep, pos, 0)

    buf = torch.zeros((E + 1, cap, d), dtype=x.dtype, device=dev)
    buf[e_idx, c_idx] = xf[tok_s]
    buf = buf[:E]

    # expert FFN (batched over experts)
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(x.dtype))
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(x.dtype))
    out_buf = torch.einsum("ecf,efd->ecd", F.silu(g) * u,
                           p["w_down"].to(x.dtype))

    # combine: weight inside the expert buffer, scatter-add to (T, d);
    # empty buffer slots point at token 0 with weight 0
    gw_s = gate_w.reshape(-1)[order]
    tok2 = torch.zeros((E + 1, cap), dtype=torch.long, device=dev)
    tok2[e_idx, c_idx] = tok_s
    gw2 = torch.zeros((E + 1, cap), dtype=torch.float32, device=dev)
    gw2[e_idx, c_idx] = gw_s
    out_w = out_buf * gw2[:E, :, None].to(out_buf.dtype)
    yt = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add_(
        0, tok2[:E].reshape(-1), out_w.reshape(E * cap, d))
    out = yt.reshape(B, S, d)

    if cfg.n_shared:
        sp = p["shared"]
        g = x @ sp["w_gate"].to(x.dtype)
        u = x @ sp["w_up"].to(x.dtype)
        out = out + (F.silu(g) * u) @ sp["w_down"].to(x.dtype)
    return out
