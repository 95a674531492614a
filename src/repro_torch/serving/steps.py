"""Serving step functions (the data-plane compute).

The reference's ``serving/steps``, run eagerly (its ``jax.jit`` has no
counterpart here; CUDA graphs are later work).  Three steps, mirroring
the paper's iteration taxonomy (Section 2.2):

* ``prefill_step``  -- full-sequence prefill of a request batch.
* ``decode_step``   -- one token for every active slot (solo iteration).
* ``mixed_step``    -- one C-token prefill chunk for a designated slot
  *fused with* one decode token for the other slots: the paper's
  mixed-mode GPU iteration.

All are ``(params, state, inputs) -> (state, outputs)`` functions that
build new cache tensors and leave their inputs as they were, as the
reference's pure functions do; :mod:`.engine` wraps them with slot
management.
"""

from __future__ import annotations

import torch

from ..compat import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_map, tree_nbytes
from ..telemetry.spans import span

__all__ = ["make_prefill_step", "make_decode_step", "make_mixed_step",
           "init_server_state", "greedy_sample"]


def greedy_sample(logits):
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def init_server_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Slot-structured server state: caches + per-slot bookkeeping."""
    device = resolve_device(device)
    return {
        "caches": M.init_cache(cfg, batch, max_len, dtype, device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        "last_token": torch.zeros((batch,), dtype=torch.int32, device=device),
        "active": torch.zeros((batch,), dtype=torch.bool, device=device),
    }


def make_prefill_step(cfg: ModelConfig, *, kernel_impl: str = "xla",
                      continuation: bool = False):
    """Whole-batch prefill: (params, caches, tokens, positions, stubs).

    ``continuation=True`` gives chunked-prefill semantics (queries attend
    over the cached context) -- the engine's mixed iterations use it.
    ``kernel_impl="pallas"`` runs a whole-prompt prefill's attention
    through the prefill attention kernel (B2).
    """

    def prefill_step(params, caches, tokens, positions, *, enc_frames=None,
                     prefix_embeds=None):
        logits, caches = M.forward_prefill(
            cfg, params, tokens, positions, caches,
            enc_frames=enc_frames, prefix_embeds=prefix_embeds,
            kernel_impl=kernel_impl, continuation=continuation)
        return caches, greedy_sample(logits)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, masked: bool = True):
    """One decode token for every slot (solo iteration).

    With ``masked=True`` (the engine path) inactive slots still *compute*
    (static shapes) but never mutate their caches -- essential when a
    mixed iteration is concurrently prefilling one of the slots.  The
    dry-run traces ``masked=False`` (all slots active), the pure decode
    iteration: the new caches are taken as computed.
    """

    def merge(new, old, act):
        # cache leaves are (layer_rep, B, ...): batch is axis 1
        def one(n, o):
            m = act.reshape((1, -1) + (1,) * (n.dim() - 2))
            return torch.where(m, n, o)
        return tree_map(one, new, old)

    def decode_step(params, state):
        with span("step.decode"):
            tokens = state["last_token"][:, None]
            positions = state["length"]
            logits, caches = M.forward_decode(
                cfg, params, tokens, positions, state["caches"])
            nxt = greedy_sample(logits)
            act = state["active"]
            if masked:
                with span("step.merge",
                          bytes=lambda: tree_nbytes(state["caches"])):
                    caches = merge(caches, state["caches"], act)
            return {
                "caches": caches,
                "length": state["length"] + act.to(torch.int32),
                "last_token": torch.where(act, nxt, state["last_token"]),
                "active": act,
            }, nxt

    return decode_step


def make_mixed_step(cfg: ModelConfig, chunk: int):
    """Fused mixed iteration: prefill ``chunk`` tokens into slot ``p_slot``
    while decoding one token on every *other* active slot.

    The chunk runs at batch=1 on a cache slice of the slot-structured state;
    decode masks out the prefilling slot.  ``prefix_embeds``, as in the
    reference, is prepended to every chunk.  Returns (state,
    decode_tokens, chunk_last_logits_token).
    """
    pf = make_prefill_step(cfg, continuation=True)
    dec = make_decode_step(cfg)

    # cache leaves are (layer_rep, B, ...): the slot/batch dim is axis 1
    def slice_slot(tree, slot):
        return tree_map(lambda a: a[:, slot:slot + 1], tree)

    def write_slot(tree, sub, slot):
        def one(a, s):
            a = a.clone()
            a[:, slot:slot + 1] = s
            return a
        return tree_map(one, tree, sub)

    def mixed_step(params, state, p_slot, chunk_tokens, chunk_pos0, *,
                   enc_frames=None, prefix_embeds=None):
        # --- prefill chunk on the designated slot (batch of 1)
        with span("step.chunk"):
            sub_cache = slice_slot(state["caches"], p_slot)
            positions = chunk_pos0 + torch.arange(
                chunk, dtype=torch.int32, device=chunk_tokens.device)[None, :]
            sub_cache, tok = pf(params, sub_cache, chunk_tokens[None, :],
                                positions, enc_frames=enc_frames,
                                prefix_embeds=prefix_embeds)
        with span("step.write_slot",
                  bytes=lambda: tree_nbytes(state["caches"])):
            caches = write_slot(state["caches"], sub_cache, p_slot)

        # --- decode everyone else
        B = state["active"].shape[0]
        mask = torch.arange(B, device=state["active"].device) != p_slot
        dstate = dict(state, caches=caches, active=state["active"] & mask)
        dstate, dec_tokens = dec(params, dstate)
        # restore the prefilling slot's activity bit
        new_state = dict(
            dstate,
            active=torch.where(mask, dstate["active"], state["active"]),
        )
        return new_state, dec_tokens, tok[0]

    return mixed_step
