"""Real-compute logical server: B decode slots over a model replica.

The reference's ``serving/engine``, with eager PyTorch in place of its
``jax.jit``: actual ``forward_prefill`` / ``forward_decode`` compute,
slot-structured caches, chunked prefill fused with decode (the paper's
mixed iteration), and **state extraction/injection** for cross-server
decode routing (the real cost behind the paper's "virtual decode buffer"
abstraction).

The engine reports calibrated iteration times from ServicePrimitives
alongside the real token outputs -- the paper's split between GPU physics
(calibrated tau) and scheduling semantics.  The engine owns its state:
the caches are allocated once and written in place by every step and on
injection, and the bookkeeping tensors (``length``, ``last_token``,
``active``) are updated in place between steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..compat import resolve_device
from ..core.types import ServicePrimitives
from ..models.config import ModelConfig
from ..models.params import tree_map
from ..telemetry.spans import span
from .steps import init_server_state, make_decode_step, make_mixed_step

__all__ = ["SlotRequest", "ServerEngine"]


@dataclass
class SlotRequest:
    """Host-side view of a request occupying a slot."""

    rid: int
    cls: int
    prompt_len: int
    decode_len: int  # target output tokens (trace-known, as in the paper)
    tokens_out: int = 0
    out_tokens: list = field(default_factory=list)


class ServerEngine:
    def __init__(self, cfg: ModelConfig, params, *, prim: ServicePrimitives,
                 max_len: int, dtype=torch.float32, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.prim = prim
        self.B = prim.batch_cap
        self.chunk = prim.chunk
        self.max_len = max_len
        self.device = resolve_device(device)
        self.state = init_server_state(cfg, self.B, max_len, dtype,
                                       self.device)
        # the engine owns its state: its steps write the caches in place
        self._decode = make_decode_step(cfg)
        self._mixed = make_mixed_step(cfg, self.chunk)
        self.slots: list[Optional[SlotRequest]] = [None] * self.B
        # host-side prefill progress (one prefill at a time, paper Section 2)
        self.prefill: Optional[tuple[SlotRequest, np.ndarray, int]] = None
        self.prefill_slot: int = -1
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------- capacity
    def free_slots(self) -> list[int]:
        reserved = {self.prefill_slot} if self.prefill else set()
        return [i for i, s in enumerate(self.slots)
                if s is None and i not in reserved]

    @property
    def has_prefill(self) -> bool:
        return self.prefill is not None

    @property
    def n_decoding(self) -> int:
        return sum(
            1 for i, s in enumerate(self.slots)
            if s is not None and i != self.prefill_slot)

    # ------------------------------------------------------------- control
    def start_prefill(self, req: SlotRequest, prompt_tokens: np.ndarray):
        assert self.prefill is None, "one prefill per server"
        free = self.free_slots()
        assert free, "no slot for prefill"
        self.prefill_slot = free[0]
        self.prefill = (req, np.asarray(prompt_tokens, np.int32), 0)
        self.slots[self.prefill_slot] = req

    def extract_slot(self, slot: int):
        """Pull a slot's state out (host trees) for migration."""
        sub = tree_map(lambda a: a[:, slot:slot + 1].to("cpu", copy=True),
                       self.state["caches"])
        meta = {
            "length": int(self.state["length"][slot]),
            "last_token": int(self.state["last_token"][slot]),
        }
        req = self.slots[slot]
        # clear the slot
        self.state["length"][slot] = 0
        self.state["active"][slot] = False
        self.slots[slot] = None
        return req, sub, meta

    def inject_slot(self, slot: int, req: SlotRequest, sub, meta):
        """Install a migrated (or freshly prefilled) state into a local
        slot."""
        assert self.slots[slot] is None

        def put(a, s):
            a[:, slot:slot + 1] = s.to(device=a.device, dtype=a.dtype)

        tree_map(put, self.state["caches"], sub)
        self.state["length"][slot] = meta["length"]
        self.state["last_token"][slot] = meta["last_token"]
        self.state["active"][slot] = True
        self.slots[slot] = req

    def activate_slot(self, slot: int):
        """Begin decoding a slot that was prefilled locally."""
        self.state["active"][slot] = True

    # ----------------------------------------------------------- iteration
    def step(self) -> dict:
        """Run one iteration (mixed if a prefill is staged, else solo).

        Returns {"tau": calibrated seconds, "completed": [SlotRequest],
        "prefill_done": SlotRequest | None, "prefill_slot": int}.
        """
        out = {"tau": 0.0, "completed": [], "prefill_done": None,
               "prefill_slot": -1}
        mixed = self.prefill is not None
        if mixed:
            req, toks, done = self.prefill
            n = min(self.chunk, len(toks) - done)
        with span("engine.step", mode="mixed" if mixed else "solo",
                  decoding=lambda: self.n_decoding,
                  chunk_tokens=n if mixed else 0):
            if mixed:
                chunk = np.zeros((self.chunk,), np.int32)  # padded (C-ref4)
                chunk[:n] = toks[done:done + n]
                self.state, dec_tokens, _ = self._mixed(
                    self.params, self.state, self.prefill_slot,
                    torch.from_numpy(chunk).to(self.device),
                    torch.full((1, 1), done, dtype=torch.int32,
                               device=self.device),
                    kv_len=done + self.chunk)
                # fix the slot's length to true progress (chunk may be
                # padded)
                slot = self.prefill_slot
                self.state["length"][slot] = done + n
                self.state["last_token"][slot] = int(toks[done + n - 1])
                out["tau"] = self.prim.alpha + self.prim.beta * n
                self._account_decode(dec_tokens, skip=slot, out=out)
                if done + n >= len(toks):
                    out["prefill_done"] = req
                    out["prefill_slot"] = slot
                    self.prefill = None
                    self.prefill_slot = -1
                else:
                    self.prefill = (req, toks, done + n)
            else:
                self.state, dec_tokens = self._decode(self.params,
                                                      self.state)
                out["tau"] = self.prim.tau_solo
                self._account_decode(dec_tokens, skip=-1, out=out)
        return out

    def _account_decode(self, dec_tokens, *, skip: int, out: dict):
        with span("step.sync"):
            toks = dec_tokens.cpu().numpy()
            active = self.state["active"].cpu().numpy()
        with span("step.account"):
            for i, req in enumerate(self.slots):
                if req is None or i == skip or i == self.prefill_slot:
                    continue
                if not active[i]:
                    continue
                req.tokens_out += 1
                req.out_tokens.append(int(toks[i]))
                if req.tokens_out >= req.decode_len:
                    out["completed"].append(req)
                    self.state["active"][i] = False
                    self.state["length"][i] = 0
                    self.slots[i] = None
