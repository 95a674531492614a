"""B4, ``kernels/csrc/mla_attention.cu``: MLA's absorbed attention, each
query over the latent cache's keys up to its position.

Each input byte counts once and each output byte once: the cache entries
a call's queries need (r + e wide: the latent and the shared RoPE key),
the queries (H heads of r + e), the outputs (H x r) and the positions.
Operations: the scores 2·H·(r + e) and the weighted sum 2·H·r a key a
query. The decode's rows the engine masks out still take part in the
call, at their own lengths, so they count too; the chunk counts its real
tokens, over the ``kv_len`` keys the host gives it.
"""

__all__ = ["decode_work", "chunk_work", "bound_s"]


def _flops_key(H: int, r: int, e: int) -> int:
    return H * (2 * (r + e) + 2 * r)


def decode_work(lengths, H: int, r: int, e: int, elem_bytes: int):
    """(bytes, FLOPs) of one decode over rows that attend ``lengths`` keys
    each."""
    keys = int(sum(int(x) for x in lengths))
    B = len(lengths)
    bytes_ = elem_bytes * ((keys + B * H) * (r + e) + B * H * r) + 4 * B
    return bytes_, keys * _flops_key(H, r, e)


def chunk_work(first: int, n: int, kv_len: int, H: int, r: int, e: int,
               elem_bytes: int):
    """(bytes, FLOPs) of one chunk of ``n`` real tokens from position
    ``first`` over the cache's first ``kv_len`` slots: query i attends
    first + i + 1 keys."""
    keys = n * first + n * (n + 1) // 2
    bytes_ = elem_bytes * ((kv_len + n * H) * (r + e) + n * H * r) + 4 * n
    return bytes_, keys * _flops_key(H, r, e)


def bound_s(work, pk: dict) -> float:
    """The least time the card could take for a call's (bytes, FLOPs)."""
    b, f = work
    return max(b / pk["hbm_bytes_s"], f / pk["bf16_flops"])
