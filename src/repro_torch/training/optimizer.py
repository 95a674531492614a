"""AdamW with cosine schedule, global-norm clipping, optional low-precision
moment states (the knob that makes 300B+ optimizer state fit a pod).

The reference's ``training/optimizer``.  Its arithmetic is in float32
(``jnp``), so the port computes on float32 tensors, Python scalars
rounded to float32 where the reference's weak types round them; the
global norm sums the leaves in ``jax.tree.leaves`` order, sorted dict
keys, where the port's trees keep insertion order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.params import tree_flatten, tree_map, tree_unzip

__all__ = ["OptConfig", "opt_init", "opt_update", "lr_at"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | const
    state_dtype: str = "float32"  # float32 | bfloat16 (m/v moments)


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: OptConfig, step):
    """The learning rate at ``step`` (an int tensor, or a Python int) as
    a float32 scalar tensor.  As in the reference, a Python step is
    divided in double precision before the float32 ops."""
    if isinstance(step, torch.Tensor):
        step = step.float()
        warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
        frac = (step - cfg.warmup_steps) / max(
            cfg.total_steps - cfg.warmup_steps, 1)
    else:
        step = float(step)
        warm = torch.clamp_max(
            _f32((step + 1) / max(cfg.warmup_steps, 1)), 1.0)
        frac = _f32((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1))
    if cfg.schedule == "const":
        return cfg.lr * warm
    frac = torch.clamp(frac, 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def opt_init(params, cfg: OptConfig):
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_flatten(params))[1].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def _global_norm(tree):
    total = 0
    for _, g in tree_flatten(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def opt_update(params, grads, state, cfg: OptConfig):
    """One AdamW step; returns (new_params, new_state, metrics).  Runs
    under ``torch.no_grad()``: the update is not differentiated."""
    with torch.no_grad():
        step = state["step"]
        gnorm = _global_norm(grads)
        scale = torch.clamp_max(cfg.clip_norm / gnorm.clamp_min(1e-12), 1.0)
        lr = lr_at(cfg, step)
        t = (step + 1).float()
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t

        def upd(p, g, m, v):
            g = g.float() * scale
            m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
            v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
            mh = m32 / bc1
            vh = v32 / bc2
            step_dir = mh / (torch.sqrt(vh) + cfg.eps)
            p32 = p.float()
            newp = p32 - lr * (step_dir + cfg.weight_decay * p32)
            return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

        out = tree_map(upd, params, grads, state["m"], state["v"])
        new_p, new_m, new_v = tree_unzip(out, 3)
        new_state = {"m": new_m, "v": new_v, "step": step + 1}
        return new_p, new_state, {"grad_norm": gnorm, "lr": lr}

