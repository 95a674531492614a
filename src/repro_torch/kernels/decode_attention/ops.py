"""Decode (one-token) GQA attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``repro.kernels.decode_attention`` (the Pallas TPU kernel
``decode_attention_pallas`` and its ``ops.decode_attention`` wrapper).
The signature is the reference's, less its TPU tiling knobs (``block_s``,
``interpret``): the CUDA kernel picks its own tiling and never pads.

Semantics, in the kernel and the plain version alike: slot ``s`` of row
``b`` is a valid key where ``s < kv_len[b]`` and, with ``window``, where
``q_positions[b] - k_positions[b, s] < window`` and ``k_positions[b, s]
<= q_positions[b]`` (positions default to the slot index and
``max(kv_len - 1, 0)``, as in the TPU kernel).  A row with no valid key
(``kv_len == 0``) yields zeros, as the TPU kernel does; the reference's
``ref.py`` instead averages V over every slot there.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..build import load
from .._checks import DTYPE_CODES, check_launch, check_tensors, refuse_grad

__all__ = ["DecodePlan", "decode_attention", "decode_attention_plain",
           "decode_plan"]

# csrc/decode_attention.cu: warps per block, stages of each warp's K/V ring
_WARPS, _STAGES = 4, 3
_RING_BYTES = 96 * 1024  # a block's K/V rings: two blocks fit on an SM
_MAX_CLUSTER = 8  # the portable thread-block cluster size
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


class DecodePlan(NamedTuple):
    """How the CUDA kernel splits one call (``decode_plan``)."""

    gc: int  # query heads a block takes (a power of two, at most 8)
    n_pass: int  # blocks over the G heads of one (b, kv head): ceil(G / gc)
    dpl: int  # output columns per lane (32 * dpl >= D)
    kw: int  # keys per warp tile
    tile: int  # the split's unit: the largest warp tile the ring holds
    n_split: int  # blocks per cluster, each over split_len keys of S
    split_len: int  # keys per block: a multiple of tile, hence of kw
    smem: int  # dynamic shared memory of a block, bytes
    rows: int  # clusters: B * KV * n_pass

    @property
    def blocks(self) -> int:
        return self.n_split * self.rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def decode_plan(B: int, S: int, H: int, KV: int, D: int, elem_bytes: int,
                n_sm: int) -> DecodePlan:
    """The kernel's split of a (B, S, H, KV, D) call on a card of ``n_sm``
    SMs.

    The S-splits of one (b, kv head, pass) are the blocks of one cluster
    (at most 8).  The cluster size is the smallest that puts at least one
    block on every SM, or the largest S allows in whole tiles of ``tile``
    keys, the largest warp tile whose rings fit ``_RING_BYTES``.  The warp
    tile ``kw`` is then the smallest (from 8 keys) that gives each of the
    4 warps at most one tile of the block's span, so short spans run on
    every warp, and their small rings let clusters of 8 fit on the card at
    once.
    """
    G = H // KV
    gc = next((c for c in (1, 2, 4) if c >= G), 8)
    n_pass = _cdiv(G, gc)
    dpl = next(c for c in (2, 4, 8) if 32 * c >= D)
    tile = next((w for w in (32, 16, 8) if
                 _WARPS * _STAGES * 2 * w * D * elem_bytes <= _RING_BYTES), 4)
    rows = B * KV * n_pass
    target = _cdiv(n_sm, rows)
    # (clusters, keys per block) for each cluster size; the same count can
    # come from several sizes, the smallest split_len balances best
    options = {}
    for n in range(1, _MAX_CLUSTER + 1):
        split_len = _cdiv(_cdiv(S, n), tile) * tile
        options.setdefault(_cdiv(S, split_len), split_len)
    n_split = min((n for n in options if n >= target), default=max(options))
    split_len = options[n_split]
    kw = min(8, tile)
    while kw < tile and _WARPS * kw < split_len:
        kw *= 2
    ring = _WARPS * _STAGES * 2 * kw * D * elem_bytes
    smem = ring + 4 * (2 * gc * D + _WARPS * kw * gc + 2 * gc)
    return DecodePlan(gc, n_pass, dpl, kw, tile, n_split, split_len, smem,
                      rows)


def _positions(kv_len, S, k_positions, q_positions):
    B = kv_len.shape[0]
    if k_positions is None:
        k_positions = torch.arange(S, dtype=torch.int32,
                                   device=kv_len.device).expand(B, S)
    if q_positions is None:
        q_positions = (kv_len - 1).clamp_min(0)
    return (k_positions.to(torch.int32).contiguous(),
            q_positions.to(torch.int32).contiguous())


def decode_attention_plain(q, k_cache, v_cache, kv_len, *, window=None,
                           k_positions=None, q_positions=None,
                           attn_softcap=None):
    """q (B,1,H,D) against caches (B,S,KV,D); kv_len (B,) -> (B,1,H,D).

    The plain version of the CUDA kernel: f32 scores and softmax, output
    in q's dtype.
    """
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    if attn_softcap is not None:
        sc = attn_softcap * torch.tanh(sc / attn_softcap)
    valid = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    if window is not None:
        kp, qp = _positions(kv_len, S, k_positions, q_positions)
        valid &= (qp[:, None] - kp < window) & (kp <= qp[:, None])
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(sc - m)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()) \
        / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, 1, H, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("decode_attention").decode_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     window: Optional[int] = None, k_positions=None,
                     q_positions=None, attn_softcap: Optional[float] = None):
    """q (B,1,H,D); caches (B,S,KV,D); kv_len (B,) -> (B,1,H,D).

    CUDA tensors launch the kernel (``csrc/decode_attention.cu``); CPU
    tensors run :func:`decode_attention_plain`.  Launches count in
    ``decode_attention.launches`` and, by route (dtype, ``decode_plan``),
    in the counter ``decode_attention.routes``.  It has no backward, so
    it refuses inputs that require grad while grad mode is on.
    """
    check_tensors("decode_attention", q, k_cache, v_cache)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[3] \
            or q.shape[2] % k_cache.shape[2]:
        raise ValueError(f"decode_attention: need q (B,1,H,D) and caches "
                         f"(B,S,KV,D) with KV | H, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if kv_len.shape != (B,) or kv_len.device != q.device \
            or kv_len.is_floating_point():
        raise ValueError("decode_attention: kv_len must be an integer (B,) "
                         "tensor on q's device")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got "
                         f"{window}")
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, kv_len, window=window,
            k_positions=k_positions, q_positions=q_positions,
            attn_softcap=attn_softcap)

    if D % 8 or D > 256:
        raise ValueError(f"decode_attention: head_dim {D} must be a multiple "
                         f"of 8 and at most 256")
    if B == 0 or S == 0:
        raise ValueError(f"decode_attention: empty batch or cache "
                         f"(B={B}, S={S}) has nothing to launch")
    kv_len = kv_len.to(torch.int32).contiguous()
    kp = qp = None
    if window is not None:
        kp, qp = _positions(kv_len, S, k_positions, q_positions)
        if kp.shape != (B, S) or qp.shape != (B,) \
                or kp.device != q.device or qp.device != q.device:
            raise ValueError("decode_attention: k_positions (B,S) and "
                             "q_positions (B,) must be on q's device")
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    plan = decode_plan(B, S, H, KV, D, q.element_size(), _sm_count(index))
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _launcher()(
        index, DTYPE_CODES[q.dtype], ptr(q), ptr(k_cache), ptr(v_cache),
        ptr(kv_len), ptr(kp), ptr(qp), ptr(out), B, S, H, KV, D, plan.gc,
        plan.dpl, plan.kw, plan.n_pass, plan.n_split, plan.split_len,
        0 if window is None else int(window), 1.0 / math.sqrt(D),
        0.0 if attn_softcap is None else float(attn_softcap), plan.smem,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    decode_attention.launches += 1
    decode_attention.routes[(str(q.dtype).split(".")[-1], plan)] += 1
    return out


decode_attention.launches = 0
decode_attention.routes = collections.Counter()  # (dtype, DecodePlan) -> n
