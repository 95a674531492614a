"""Prefill flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro.kernels.prefill_attention`` (the Pallas TPU kernel
``prefill_attention_pallas`` and its ``ops.prefill_attention`` wrapper).
The signature is the reference's, less its TPU tiling knobs
(``block_q``, ``block_k``, ``interpret``).  Unlike the TPU wrapper it
pads nothing: the kernel masks keys at or past the true length, so it
equals the reference's ``ref.py`` at every S, causal or not (the TPU
wrapper does not there: ROADMAP C-ref1).  Beyond the reference it takes
a chunk of queries over a longer cache: ``q_offset`` places the chunk's
first query, and ``kv_len`` ends the keys, both (B,) int32 on the
device, so ``models.attention``'s continuation chunk launches it with
no host sync.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from ..build import load
from .._checks import DTYPE_CODES, check_launch, check_tensors, refuse_grad

__all__ = ["prefill_attention", "prefill_attention_plain"]

_HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in the kernel
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("prefill_attention").prefill_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def prefill_attention_plain(q, k, v, *, causal=True, window=None,
                            attn_softcap=None, prefix_len=None,
                            q_offset=None, kv_len=None):
    """q (B,Sq,H,D); k, v (B,Skv,KV,D) -> (B,Sq,H,D).

    The plain version of the CUDA kernel: GQA by head repetition, f32
    scores and softmax, output in q's dtype.  Query row i of batch row b
    sits at position ``q_offset[b] + i`` (0 + i without it); keys are at
    their indices, and those at or past ``kv_len[b]`` (Skv without it)
    are masked.
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    G = H // k.shape[2]
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * (1.0 / math.sqrt(D))
    if attn_softcap is not None:
        sc = attn_softcap * torch.tanh(sc / attn_softcap)
    qpos = torch.arange(Sq, device=q.device)[None, :, None]
    if q_offset is not None:
        qpos = qpos + q_offset.long().reshape(B, 1, 1)
    kpos = torch.arange(Skv, device=q.device)[None, None, :]
    mask = torch.ones((1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    if prefix_len is not None:
        mask = mask | (kpos < prefix_len)
    if kv_len is not None:
        mask = mask & (kpos < kv_len.long().reshape(B, 1, 1))
    p = torch.softmax(sc.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


def prefill_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      attn_softcap: Optional[float] = None,
                      prefix_len: Optional[int] = None,
                      q_offset: Optional[torch.Tensor] = None,
                      kv_len: Optional[torch.Tensor] = None):
    """q (B,Sq,H,D); k, v (B,Skv,KV,D) -> (B,Sq,H,D).

    A whole prompt is Sq = Skv with neither ``q_offset`` nor ``kv_len``.
    A chunk over a longer cache gives ``q_offset``, the position of each
    batch row's first query, and ``kv_len``, its number of keys (at most
    Skv): integer (B,) tensors on q's device, which the kernel reads
    there.  Keys sit at their indices.

    CUDA tensors launch the kernel (``csrc/prefill_attention.cu``): bf16
    the tensor-core route, f32 the FP32-pipe route (TF32 would not hold
    f32 to its 3e-5).  CPU tensors run :func:`prefill_attention_plain`.
    Launches count in ``prefill_attention.launches``, by route in
    ``prefill_attention.launches_tc`` and ``launches_fp32``, and by
    ``prefix_len`` in the counter ``prefill_attention.prefix_lens``.  It
    has no backward, so it refuses inputs that require grad while grad
    mode is on.
    """
    check_tensors("prefill_attention", q, k, v)
    refuse_grad("prefill_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"prefill_attention: need q (B,Sq,H,D) and k, v "
                         f"(B,Skv,KV,D) with KV | H, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B = q.shape[0]
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t is not None and (t.shape != (B,) or t.device != q.device
                              or t.is_floating_point()):
            raise ValueError(f"prefill_attention: {name} must be an integer "
                             f"(B,) tensor on q's device")
    if q_offset is None and kv_len is None and k.shape[1] != q.shape[1]:
        raise ValueError(f"prefill_attention: a whole prompt needs Sq == "
                         f"Skv, got {q.shape[1]} and {k.shape[1]}; a chunk "
                         f"gives q_offset and kv_len")
    if window is not None and window <= 0:
        raise ValueError(f"prefill_attention: window must be positive, got "
                         f"{window}")
    if prefix_len is not None and prefix_len < 0:
        raise ValueError(f"prefill_attention: prefix_len must be >= 0, got "
                         f"{prefix_len}")
    if q.device.type in ("cpu", "meta"):
        return prefill_attention_plain(q, k, v, causal=causal, window=window,
                                       attn_softcap=attn_softcap,
                                       prefix_len=prefix_len,
                                       q_offset=q_offset, kv_len=kv_len)

    B, S, H, D = q.shape
    Skv = k.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"prefill_attention: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if B == 0 or S == 0 or Skv == 0:
        raise ValueError(f"prefill_attention: empty batch or sequence "
                         f"(B={B}, Sq={S}, Skv={Skv}) has nothing to launch")
    q_offset, kv_len = (None if t is None else t.to(torch.int32).contiguous()
                        for t in (q_offset, kv_len))
    out = torch.empty_like(q)
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    err = _launcher()(
        index, DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, Skv, H, k.shape[2], D,
        None if q_offset is None else q_offset.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(), int(bool(causal)),
        0 if window is None else int(window),
        -1 if prefix_len is None else int(prefix_len), 1.0 / math.sqrt(D),
        0.0 if attn_softcap is None else float(attn_softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("prefill_attention", err)
    prefill_attention.launches += 1
    if q.dtype == torch.bfloat16:
        prefill_attention.launches_tc += 1
    else:
        prefill_attention.launches_fp32 += 1
    prefill_attention.prefix_lens[prefix_len] += 1
    return out


prefill_attention.launches = 0
prefill_attention.launches_tc = 0  # bf16: wgmma tensor-core kernel
prefill_attention.launches_fp32 = 0  # f32: FP32-pipe kernel
prefill_attention.prefix_lens = collections.Counter()  # prefix_len -> n
