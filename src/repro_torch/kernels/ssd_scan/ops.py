"""Mamba-2 SSD chunk scan: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``ssd_scan_pallas`` and its ``ops.ssd_scan`` wrapper).  The signature is
the reference oracle's (``ref.ssd_scan_ref``, with its optional
``initial_state``), less the TPU's tiling knobs (``chunk``,
``interpret``): chunking the scan is exact, so the kernel picks its own
chunk, takes any S and never halves a chunk to divide S.  Both versions
accumulate in f32 and round y once to x's dtype; the state is f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import load
from .._checks import DTYPE_CODES, check_launch, check_tensors

__all__ = ["ssd_scan", "ssd_scan_plain"]

_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
_P_BLOCK = 16  # columns of y per block (csrc/ssd_scan.cu, kPB)
_MAX_N = 256


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("ssd_scan").ssd_scan_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def ssd_scan_plain(x_dt, Bm, Cm, log_a, *, chunk: int = 256,
                   initial_state=None):
    """x_dt (B,S,H,P); Bm/Cm (B,S,N); log_a (B,S,H) ->
    (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32).

    The plain version of the CUDA kernel: the TPU kernel's body
    (dual form within a chunk, carried state across chunks) looped over
    chunks of ``chunk`` tokens (the last one may be shorter), in f32 (in
    f64 for f64 inputs, a yardstick of precision).  The state is returned
    in that type.
    """
    Bsz, S, H, P = x_dt.shape
    N = Bm.shape[-1]
    acc = torch.promote_types(x_dt.dtype, torch.float32)
    x, Bf, Cf, la = (t.to(acc) for t in (x_dt, Bm, Cm, log_a))
    h = (initial_state.to(acc) if initial_state is not None else
         torch.zeros((Bsz, H, P, N), dtype=acc, device=x_dt.device))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        q = sl.stop - c0
        cum = torch.cumsum(la[:, sl], dim=1)                      # (B,q,H)
        tri = torch.ones((q, q), dtype=torch.bool,
                         device=x.device).tril()[None, :, :, None]
        # L[t,s] = exp(cum_t - cum_s) for s <= t; exp only where defined
        diff = cum[:, :, None, :] - cum[:, None, :, :]            # (B,t,s,H)
        L = torch.exp(diff.masked_fill(~tri, float("-inf")))
        cb = torch.einsum("btn,bsn->bts", Cf[:, sl], Bf[:, sl])
        y = torch.einsum("btsh,bshp->bthp", cb[..., None] * L, x[:, sl])
        y = y + torch.einsum("btn,bhpn->bthp", Cf[:, sl], h) \
            * torch.exp(cum)[..., None]
        ys.append(y)
        seg = torch.exp(cum[:, -1:] - cum)                        # (B,q,H)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bsn,bshp,bsh->bhpn", Bf[:, sl], x[:, sl], seg)
    return torch.cat(ys, dim=1).to(x_dt.dtype), h


def ssd_scan(x_dt, Bm, Cm, log_a, *, initial_state=None):
    """x_dt (B,S,H,P); Bm/Cm (B,S,N); log_a (B,S,H) f32; optional
    initial_state (B,H,P,N) f32 -> (y (B,S,H,P), final_state (B,H,P,N)).

    CUDA tensors launch the kernel (``csrc/ssd_scan.cu``); CPU tensors run
    :func:`ssd_scan_plain`.
    """
    check_tensors("ssd_scan", x_dt, Bm, Cm)
    if x_dt.dim() != 4 or Bm.dim() != 3 or Bm.shape != Cm.shape \
            or Bm.shape[:2] != x_dt.shape[:2] \
            or log_a.shape != x_dt.shape[:3]:
        raise ValueError(f"ssd_scan: need x_dt (B,S,H,P), Bm and Cm (B,S,N) "
                         f"and log_a (B,S,H), got {tuple(x_dt.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}, "
                         f"{tuple(log_a.shape)}")
    Bsz, S, H, P = x_dt.shape
    N = Bm.shape[-1]
    f32 = [log_a] + ([initial_state] if initial_state is not None else [])
    check_tensors("ssd_scan", *f32)
    if log_a.dtype != torch.float32 or log_a.device != x_dt.device:
        raise ValueError("ssd_scan: log_a and initial_state must be float32 "
                         "on x_dt's device")
    if initial_state is not None and initial_state.shape != (Bsz, H, P, N):
        raise ValueError(f"ssd_scan: initial_state must be {(Bsz, H, P, N)}, "
                         f"got {tuple(initial_state.shape)}")
    if x_dt.device.type == "cpu":
        return ssd_scan_plain(x_dt, Bm, Cm, log_a,
                              initial_state=initial_state)

    if P % _P_BLOCK or N % 8 or not 0 < N <= _MAX_N:
        raise ValueError(f"ssd_scan: head_dim P={P} must be a multiple of "
                         f"{_P_BLOCK}, and d_state N={N} a multiple of 8 up "
                         f"to {_MAX_N}")
    if Bsz == 0 or S == 0 or H == 0:
        raise ValueError(f"ssd_scan: empty input (B={Bsz}, S={S}, H={H}) "
                         f"has nothing to launch")
    y = torch.empty_like(x_dt)
    h_out = torch.empty((Bsz, H, P, N), dtype=torch.float32,
                        device=x_dt.device)
    index = x_dt.device.index if x_dt.device.index is not None \
        else torch.cuda.current_device()
    err = _launcher()(
        index, DTYPE_CODES[x_dt.dtype], x_dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), log_a.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), h_out.data_ptr(), Bsz, S, H, P, N,
        torch.cuda.current_stream(x_dt.device).cuda_stream)
    check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0
