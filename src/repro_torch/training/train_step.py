"""The training step.

The reference's ``training/train_step``: ``make_train_step`` builds a
functional ``(state, batch) -> (state, metrics)`` step with

* remat (activation checkpointing) at layer-superblock granularity
  (``torch.utils.checkpoint``, ``models.model``),
* optional gradient accumulation over microbatches, in order, in f32,
* AdamW with clipping/schedule (:mod:`repro_torch.training.optimizer`),
* an optional ``grad_transform`` on the raw grads before the optimizer,
  e.g. the int8 error-feedback all-reduce of
  :mod:`repro_torch.training.compress`.

Grads are taken with ``torch.autograd.grad`` on detached copies of the
params (the reference's ``jax.value_and_grad``), and the update runs
under ``torch.no_grad()``: neither the state passed in nor the one
returned carries an autograd graph.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_map
from .optimizer import OptConfig, opt_init, opt_update

__all__ = ["make_loss", "make_train_step", "init_train_state"]


def make_loss(cfg: ModelConfig, *, remat: bool = True) -> Callable:
    def loss(params, batch):
        return M.loss_fn(
            cfg, params, batch["tokens"], batch["labels"],
            prefix_embeds=batch.get("prefix_embeds"),
            enc_frames=batch.get("enc_frames"), remat=remat)
    return loss


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     opt: OptConfig, dtype=torch.float32,
                     device=None) -> dict:
    params = M.init_model(cfg, generator, dtype, device)
    return {"params": params, "opt": opt_init(params, opt)}


def value_and_grad(loss_f: Callable, params, batch):
    """``(loss, grads)`` of ``loss_f(params, batch)``, grads in the
    params' tree and dtypes (zeros for a leaf the loss does not reach)."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_f(pytree.tree_unflatten(req, spec), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def make_train_step(cfg: ModelConfig, opt: OptConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` maps ``tokens``/``labels`` (B, S) (and ``prefix_embeds``
    or ``enc_frames`` where the config takes them) to tensors on the
    params' device.  With ``microbatches`` > 1 the batch is cut along B
    into that many equal slices, their f32 grads summed in order and
    divided, as the reference's ``lax.scan`` does.  ``grad_transform``
    is applied to the raw grads before the optimizer.
    """
    loss_f = make_loss(cfg, remat=remat)

    def step(state, batch):
        params = state["params"]
        if microbatches <= 1:
            loss, grads = value_and_grad(loss_f, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(microbatches):
                mb_batch = {k: v.chunk(microbatches)[i]
                            for k, v in batch.items()}
                l, g = value_and_grad(loss_f, params, mb_batch)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, new_opt, om = opt_update(params, grads, state["opt"], opt)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **om}

    return step
