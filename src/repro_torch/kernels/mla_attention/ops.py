"""Latent attention (MLA's absorbed form): the CUDA kernel's wrapper (B4)
and its plain PyTorch version.

Replaces no TPU kernel: the reference's MLA attends with plain
``jnp.einsum`` (``repro.models.mla``), and the plain version here is that
arithmetic as ``models.mla`` ran it: scores in f32 over every slot of the
cache up to ``kv_len``, the slots past each query's position masked, the
softmax in f32, the probabilities rounded to the queries' dtype and
multiplied into the latents.  B4 (``csrc/mla_attention.cu``) computes the
same over each query's keys alone, in bf16 on the tensor cores with f32
accumulation, and reads no key past a query's last one.

Semantics, in the kernel and the plain version alike: query ``(b, i)``
attends keys ``0 .. min(positions[b, i], kv_len - 1)`` of cache row ``b``,
a key's score being ``(q_lat . c_kv + q_rope . k_rope) * scale``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..build import load
from .._checks import check_launch, check_tensors, refuse_grad
from ..decode_attention.ops import _cdiv, _sm_count

__all__ = ["mla_attention", "mla_attention_plain", "mla_split"]

_LAT, _ROPE = 512, 64  # the widths the kernel takes (DeepSeek-V2/V3's)
_ROWS = 64  # heads of a block's tile: H must be a multiple
_BK = 64  # keys of a tile
_SPLIT = 1024  # keys of a piece, when a call is split
_NEG = -2.0e9  # the mask value of models.attention
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("mla_attention").mla_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


@functools.lru_cache(maxsize=4096)
def mla_split(N: int, H: int, kv_len: int, n_sm: int) -> Tuple[int, int]:
    """(split, n_split): keys of a piece and pieces of a call over ``N``
    queries of ``H`` heads and at most ``kv_len`` keys on ``n_sm`` SMs.

    The kernel's blocks are (piece, 64 heads, query).  A call whose
    (query, 64 heads) tiles fill the card twice over (the chunk's 512
    queries) runs in one piece; otherwise (a decode's 64 rows) in pieces
    of 1024 keys, so that a long row spreads over several SMs and the
    rows' pieces are summed after.
    """
    whole = _cdiv(kv_len, _BK) * _BK
    if N * (H // _ROWS) >= 2 * n_sm or whole <= _SPLIT:
        return whole, 1
    return _SPLIT, _cdiv(kv_len, _SPLIT)


def mla_attention_plain(q_lat, q_rope, c_kv, k_rope, positions, *,
                        scale: float, kv_len: Optional[int] = None):
    """q_lat (B,Sq,H,R), q_rope (B,Sq,H,Dr); c_kv (B,S,R), k_rope (B,S,Dr);
    positions (B,Sq) -> ctx (B,Sq,H,R).

    Scores and softmax in f32 over the cache's first ``kv_len`` slots (S
    without it), keys past each query's position masked; the
    probabilities in q's dtype; ctx in the common type of q and the cache
    (``jnp.einsum``'s promotion), as ``models.mla`` computed it.
    """
    if kv_len is not None:
        c_kv, k_rope = c_kv[:, :kv_len], k_rope[:, :kv_len]
    sc = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv.float())
          + torch.einsum("bqhk,bsk->bhqs", q_rope.float(), k_rope.float())) \
        * float(scale)
    kpos = torch.arange(c_kv.shape[1], device=q_lat.device)
    sc = sc.masked_fill(kpos[None, None, None, :]
                        > positions[:, None, :, None], _NEG)
    p = torch.softmax(sc, dim=-1).to(q_lat.dtype)
    dt = torch.promote_types(p.dtype, c_kv.dtype)
    return torch.einsum("bhqs,bsr->bqhr", p.to(dt), c_kv.to(dt))


def mla_attention(q_lat, q_rope, c_kv, k_rope, positions, *, scale: float,
                  kv_len: Optional[int] = None):
    """q_lat (B,Sq,H,512), q_rope (B,Sq,H,64); c_kv (B,S,512), k_rope
    (B,S,64), one dtype; positions (B,Sq) integer on q's device; ``kv_len``
    a host int in 1..S (S without it) -> ctx (B,Sq,H,512).

    The decode is Sq = 1 with each row's position; the continuation
    chunk is B = 1 with its queries' positions and the chunk's end as
    ``kv_len``.  CUDA tensors launch B4 (``csrc/mla_attention.cu``), bf16
    only, H a multiple of 64: positions are read on the card, so the call
    never waits on it.  CPU tensors run :func:`mla_attention_plain`.
    Calls count in ``mla_attention.launches`` (three kernels a split
    call, two an unsplit one).  It has no backward, so it refuses inputs
    that require grad while grad mode is on.
    """
    check_tensors("mla_attention", q_lat, q_rope, c_kv, k_rope)
    refuse_grad("mla_attention", q_lat, q_rope, c_kv, k_rope)
    if q_lat.dim() != 4 or q_rope.shape[:3] != q_lat.shape[:3] \
            or c_kv.dim() != 3 or k_rope.shape[:2] != c_kv.shape[:2] \
            or c_kv.shape[0] != q_lat.shape[0] \
            or c_kv.shape[2] != q_lat.shape[3] \
            or k_rope.shape[2] != q_rope.shape[3]:
        raise ValueError(f"mla_attention: need q_lat (B,Sq,H,R), q_rope "
                         f"(B,Sq,H,Dr), c_kv (B,S,R), k_rope (B,S,Dr), got "
                         f"{tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(c_kv.shape)}, {tuple(k_rope.shape)}")
    B, Sq, H, R = q_lat.shape
    S = c_kv.shape[1]
    if positions.shape != (B, Sq) or positions.device != q_lat.device \
            or positions.is_floating_point():
        raise ValueError(f"mla_attention: positions must be an integer "
                         f"(B, Sq) = {(B, Sq)} tensor on q's device, got "
                         f"{tuple(positions.shape)} on {positions.device}")
    if kv_len is not None and not 1 <= kv_len <= S:
        raise ValueError(f"mla_attention: kv_len must lie in 1..{S}, got "
                         f"{kv_len}")
    if q_lat.device.type in ("cpu", "meta"):
        return mla_attention_plain(q_lat, q_rope, c_kv, k_rope, positions,
                                   scale=scale, kv_len=kv_len)

    if q_lat.dtype != torch.bfloat16:
        raise TypeError(f"mla_attention: the kernel takes bf16, got "
                        f"{q_lat.dtype} (f32 caches take "
                        f"mla_attention_plain)")
    if R != _LAT or q_rope.shape[3] != _ROPE or H % _ROWS:
        raise ValueError(f"mla_attention: the kernel takes R = {_LAT}, "
                         f"Dr = {_ROPE} and H a multiple of {_ROWS}, got "
                         f"R = {R}, Dr = {q_rope.shape[3]}, H = {H}")
    if B * Sq == 0:
        raise ValueError("mla_attention: no query to launch")
    index = q_lat.device.index if q_lat.device.index is not None \
        else torch.cuda.current_device()
    kv = S if kv_len is None else int(kv_len)
    N = B * Sq
    split, n_split = mla_split(N, H, kv, _sm_count(index))
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty_like(q_lat)
    stats = torch.empty((n_split, N, H, 2), dtype=torch.float32,
                        device=q_lat.device)
    part = torch.empty((n_split, N, H, R), dtype=torch.float32,
                       device=q_lat.device) if n_split > 1 else None
    err = _launcher()(
        index, q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), pos.data_ptr(), out.data_ptr(), stats.data_ptr(),
        None if part is None else part.data_ptr(), N, Sq, H, S, kv, split,
        n_split, float(scale), torch.cuda.current_stream(q_lat.device)
        .cuda_stream)
    check_launch("mla_attention", err)
    mla_attention.launches += 1
    return out


mla_attention.launches = 0
