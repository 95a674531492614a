"""Serving step functions (the data-plane compute).

The reference's ``serving/steps``, run eagerly (its ``jax.jit`` has no
counterpart here; CUDA graphs are later work).  Three steps, mirroring
the paper's iteration taxonomy (Section 2.2):

* ``prefill_step``  -- full-sequence prefill of a request batch.
* ``decode_step``   -- one token for every active slot (solo iteration).
* ``mixed_step``    -- one C-token prefill chunk for a designated slot
  *fused with* one decode token for the other slots: the paper's
  mixed-mode GPU iteration.

All are ``(params, state, inputs) -> (state, outputs)`` functions.  The
reference's are pure; these write the caches they are given where those
lie (``models.model.forward_prefill``), and return them in the new state
beside new bookkeeping tensors.  :mod:`.engine` owns its state and wraps
them with slot management; a caller who reads a state again after
stepping it copies it first.
"""

from __future__ import annotations

import torch

from ..compat import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_flatten, tree_map
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
    over the cached context up to ``kv_len``, a host int past the
    chunk's last position: ``models.model.forward_prefill``).
    ``kernel_impl="pallas"`` runs a whole-prompt prefill's attention
    through the prefill attention kernel (B2).
    """

    def prefill_step(params, caches, tokens, positions, *, enc_frames=None,
                     prefix_embeds=None, kv_len=None):
        logits, caches = M.forward_prefill(
            cfg, params, tokens, positions, caches,
            enc_frames=enc_frames, prefix_embeds=prefix_embeds,
            kernel_impl=kernel_impl, continuation=continuation,
            kv_len=kv_len)
        return caches, greedy_sample(logits)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, masked: bool = True):
    """One decode token for every slot (solo iteration).

    With ``masked=True`` (the engine path) inactive slots still *compute*
    (static shapes) but end with their caches as they were, bit for bit
    -- essential when a mixed iteration is concurrently prefilling one of
    the slots.  The blend is at the position each row writes
    (``models.model.forward_decode``), not over the caches.  The
    dry-run traces ``masked=False`` (all slots active), the pure decode
    iteration: the new caches are taken as computed.
    """

    def decode_step(params, state):
        with span("step.decode"):
            act = state["active"]
            logits, caches = M.forward_decode(
                cfg, params, state["last_token"][:, None], state["length"],
                state["caches"], active=act if masked else None)
            nxt = greedy_sample(logits)
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

    The chunk runs at batch=1 on the slot's view of the slot-structured
    caches and writes through it; the decode then runs on the same caches
    and masks out the prefilling slot.  ``prefix_embeds``, as in the
    reference, is prepended to every chunk.  ``kv_len``, a host int past
    the chunk's last position (the engine gives the chunk's end), is
    required: it cuts the chunk's attention there
    (``models.model.forward_prefill``).  Returns (state, decode_tokens,
    chunk_last_logits_token).
    """
    dec = make_decode_step(cfg)

    def mixed_step(params, state, p_slot, chunk_tokens, chunk_pos0, *,
                   kv_len, enc_frames=None, prefix_embeds=None):
        caches = state["caches"]
        # --- prefill chunk on the designated slot (batch of 1)
        with span("step.chunk"):
            # cache leaves are (layer_rep, B, ...): the slot/batch dim is
            # axis 1
            view = tree_map(lambda a: a[:, p_slot:p_slot + 1], caches)
            positions = chunk_pos0 + torch.arange(
                chunk, dtype=torch.int32, device=chunk_tokens.device)[None, :]
            logits, sub = M.forward_prefill(
                cfg, params, chunk_tokens[None, :], positions, view,
                enc_frames=enc_frames, prefix_embeds=prefix_embeds,
                continuation=True, kv_len=kv_len)
            tok = greedy_sample(logits)
        # a leaf the chunk gave a dtype of its own (the cross-attention
        # K/V in the activations') goes into the slot in the cache's
        moved = [(v, n) for (_, v), (_, n) in zip(tree_flatten(view),
                                                   tree_flatten(sub))
                 if n is not v]
        if moved:
            with span("step.write_slot",
                      bytes=lambda: sum(v.numel() * v.element_size()
                                        for v, _ in moved)):
                for v, n in moved:
                    v.copy_(n)

        # --- decode everyone else
        B = state["active"].shape[0]
        mask = torch.arange(B, device=state["active"].device) != p_slot
        dstate = dict(state, caches=caches, active=state["active"] & mask)
        dstate, dec_tokens = dec(params, dstate)
        # the prefilling slot's activity bit, as it was
        return dict(dstate, active=state["active"]), dec_tokens, tok[0]

    return mixed_step
