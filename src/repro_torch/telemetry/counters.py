"""Counters: totals the program adds up on the card while ``torch.profiler``
runs (the gate the spans use), read once after the traced window.

:func:`moe_dispatch` is called by ``models.moe.apply_moe``: the token
copies computed for the experts held here (``kept``), the copies the
router sent to them (``routed``: ``kept`` plus those past an expert's
capacity) and the dispatch rows launched (held experts x capacity).  The
two copy counts are device scalars added into a device accumulator, so a
traced step launches a few small kernels more and never waits on the card;
the rows are a host integer.  While the profiler is off, ``apply_moe``
checks :func:`on` once and calls nothing.  :func:`moe_totals` reads the
totals (one copy to the host) and :func:`reset` clears them.

:func:`chunk_attention` is called by ``models.attention.attention_prefill``
for each continuation chunk, by the route it took: B2 over the cache up
to the chunk's end, or the blockwise path over the whole cache.  Host
integers only; :func:`chunk_totals` reads them.
"""

from __future__ import annotations

import torch

__all__ = ["on", "moe_dispatch", "moe_totals", "chunk_attention",
           "chunk_totals", "reset"]

on = torch.autograd._profiler_enabled


class _MoE:
    def __init__(self):
        self.dev = None  # (kept, routed) on the card, int64
        self.rows = 0
        self.calls = 0


_MOE = _MoE()
_CHUNK = {"b2": 0, "blockwise": 0}


def moe_dispatch(kept, routed, rows: int):
    """Add one ``apply_moe`` call: ``kept`` and ``routed`` device scalars,
    ``rows`` the dispatch rows it launched."""
    d = torch.stack((kept, routed))
    if _MOE.dev is None or _MOE.dev.device != d.device:
        _MOE.dev = torch.zeros_like(d)
    _MOE.dev.add_(d)
    _MOE.rows += int(rows)
    _MOE.calls += 1


def moe_totals():
    """{"calls", "kept", "dropped", "rows"} since the last :func:`reset`, or
    None if nothing was counted."""
    if not _MOE.calls:
        return None
    kept, routed = (int(v) for v in _MOE.dev.tolist())
    return {"calls": _MOE.calls, "kept": kept, "dropped": routed - kept,
            "rows": _MOE.rows}


def chunk_attention(b2: bool):
    """Add one continuation chunk's attention call, through B2 or not."""
    _CHUNK["b2" if b2 else "blockwise"] += 1


def chunk_totals():
    """{"b2", "blockwise"} calls since the last :func:`reset`."""
    return dict(_CHUNK)


def reset():
    _MOE.dev, _MOE.rows, _MOE.calls = None, 0, 0
    _CHUNK.update(b2=0, blockwise=0)
