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

import ctypes
import functools
import math
from typing import Optional

import torch

from ..build import load
from .._checks import DTYPE_CODES, check_launch, check_tensors

__all__ = ["decode_attention", "decode_attention_plain"]

_TILE_ELEMS = 4096  # keys per shared-memory tile x head_dim
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(S: int, n_rows: int, tile: int, n_sm: int):
    """Split S into whole tiles so that about four blocks per SM are in
    flight; returns ``(n_split, split_len)``."""
    n_split = max(1, min(_cdiv(4 * n_sm, n_rows), _cdiv(S, tile)))
    split_len = _cdiv(_cdiv(S, n_split), tile) * tile
    return _cdiv(S, split_len), split_len


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     window: Optional[int] = None, k_positions=None,
                     q_positions=None, attn_softcap: Optional[float] = None):
    """q (B,1,H,D); caches (B,S,KV,D); kv_len (B,) -> (B,1,H,D).

    CUDA tensors launch the kernel (``csrc/decode_attention.cu``); CPU
    tensors run :func:`decode_attention_plain`.
    """
    check_tensors("decode_attention", q, k_cache, v_cache)
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
    G = H // KV
    tile = max(8, _TILE_ELEMS // D)
    smem = 4 * (2 * G * D + tile * (2 * D + 1) + G * tile + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: G={G}, D={D} needs {smem} B of "
                         f"shared memory, more than {_SMEM_LIMIT}")
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
    n_split, split_len = _split(S, B * KV, tile, _sm_count(index))
    out = torch.empty_like(q)
    part_m = part_l = part_acc = None
    if n_split > 1:  # one scratch buffer: m and l per (row, split, head), acc
        n = B * KV * n_split * G
        scratch = torch.empty(n * (D + 2), dtype=torch.float32,
                              device=q.device)
        part_m, part_l, part_acc = scratch[:n], scratch[n:2 * n], \
            scratch[2 * n:]

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _launcher()(
        index, DTYPE_CODES[q.dtype], ptr(q), ptr(k_cache), ptr(v_cache),
        ptr(kv_len), ptr(kp), ptr(qp), ptr(out), ptr(part_m), ptr(part_l),
        ptr(part_acc), B, S, H, KV, D, tile,
        0 if window is None else int(window), 1.0 / math.sqrt(D),
        0.0 if attn_softcap is None else float(attn_softcap), n_split,
        split_len, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
