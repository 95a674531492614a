"""Int8 error-feedback gradient compression for the data-parallel all-reduce.

The reference's ``training/compress``, over a ``torch.distributed``
process group in place of a ``shard_map`` mesh axis.  Each data-parallel
rank quantises its local gradient to int8 with a per-tensor scale,
all-reduces the int8 payload (summed as int32, so it cannot overflow;
8x fewer bytes than f32 on the wire in the reference's design), and the
scales beside it, dequantises, and keeps the quantisation residual
locally, adding it back before the next step (error feedback keeps the
scheme convergent).  The arithmetic is the reference's, op for op.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.params import tree_map, tree_unzip

__all__ = ["init_residuals", "make_compressed_psum", "quantize_int8",
           "dequantize_int8"]


def quantize_int8(x):
    """Per-tensor symmetric int8 quantisation; returns (q, scale)."""
    amax = x.abs().amax()
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_compressed_psum(group=None):
    """Returns ``f(grads, residuals) -> (mean_grads, new_residuals)``.

    Every rank of ``group`` (default: the world) calls ``f`` with its
    local grads; each leaf costs two all-reduces, the int32-summed int8
    payload and the scale.  The group must be up
    (``torch.distributed.init_process_group``).
    """
    n = dist.get_world_size(group)

    def psum_one(g, r):
        g = g.float() + r
        q, scale = quantize_int8(g)
        new_r = g - dequantize_int8(q, scale)  # error feedback
        qsum = q.to(torch.int32)
        ssum = scale.reshape(1).clone()
        dist.all_reduce(qsum, group=group)
        dist.all_reduce(ssum, group=group)
        mean = qsum.float() * (ssum[0] / n) / n
        return mean, new_r

    def f(grads, residuals):
        out = tree_map(psum_one, grads, residuals)
        return tree_unzip(out, 2)

    return f

