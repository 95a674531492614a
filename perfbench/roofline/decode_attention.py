"""B1, ``kernels/csrc/decode_attention.cu``: one query token per row
against that row's first ``kv_len`` cached keys and values.

Each input byte counts once and each output byte once: per row the
``kv_len`` keys and values it must read, its query and its output, and
its ``kv_len`` entry. Operations: scores and the weighted sum, 4 H D a
key. Rows the engine masks out still take part in the call, at their own
``kv_len``, so they count too.
"""

import numpy as np

__all__ = ["work"]


def work(kv_len, H: int, KV: int, D: int, elem_bytes: int):
    """(bytes, FLOPs) of one call over rows with ``kv_len`` keys each."""
    n = float(np.sum(kv_len))
    B = len(kv_len)
    bytes_ = elem_bytes * (2 * n * KV * D + 2 * B * H * D) + 4 * B
    return bytes_, 4.0 * H * D * n


def bound_s(kv_len, H, KV, D, elem_bytes, pk: dict) -> float:
    """The least time the card could take for the call."""
    b, f = work(kv_len, H, KV, D, elem_bytes)
    return max(b / pk["hbm_bytes_s"], f / pk["bf16_flops"])
