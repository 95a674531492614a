"""Mamba-2 SSD chunk scan: the CUDA kernels' wrapper and their plain
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
from typing import NamedTuple

import torch

from ..build import load
from .._checks import DTYPE_CODES, check_launch, check_tensors

__all__ = ["SSDPlan", "ssd_plan", "ssd_scan", "ssd_scan_plain"]

_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
_P_ALIGN = 16  # head_dim P: a multiple of the kernels' 16-column tiles
_MAX_N = 256
# csrc/ssd_scan.cu, the bf16 route: tokens per chunk (kQ), columns of P a
# block at most (kMaxPB), bf16 padding of a staged row (kPad)
_CHUNK, _MAX_PB, _PAD = 128, 64, 8
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use (sm_90)


class SSDPlan(NamedTuple):
    """How the bf16 route runs one call (``ssd_plan``)."""

    route: str  # "one-chunk" (S <= chunk, zero state) or "multi-chunk"
    chunk: int  # tokens per chunk, Q
    n_chunks: int
    hb: int  # heads a block takes (the last group may be short)
    pb: int  # columns of P a block takes: divides P, a multiple of 16
    blocks: int  # blocks of each chunk-kernel launch
    kernels: int  # launches per call: 1, or state + carry + y
    scratch_bytes: int  # f32 chunk states and decays the wrapper allocates
    smem: int  # the chunk kernel's largest dynamic shared memory, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem(qr: int, N: int, pb: int, hb: int, state: bool, y: bool,
          inter: bool) -> int:
    """Dynamic shared memory of one chunk-kernel launch (csrc/ssd_scan.cu,
    ``tc::layout``): cum (and seg, state mode) of every head, B and C (y
    mode) of qr rows, x of a head (two buffers), the carried state as
    loaded and as three bf16 terms (inter), x o seg as three terms
    (state)."""
    ldb = _cdiv(N, 16) * 16 + _PAD
    return (4 * _CHUNK * hb * (2 if state else 1)
            + 2 * qr * ldb * (2 if y else 1)
            + 4 * qr * (pb + _PAD)
            + (4 * pb * N + 6 * pb * ldb if inter else 0)
            + (6 * pb * (qr + _PAD) if state else 0))


@functools.lru_cache(maxsize=4096)
def ssd_plan(B: int, S: int, H: int, P: int, N: int, with_state: bool,
             n_sm: int) -> SSDPlan:
    """The bf16 route's split of a (B, S, H, P, N) call on a card of
    ``n_sm`` SMs.

    One chunk from a zero state (S <= Q, the serving engine's call) is one
    launch that writes the state straight out; anything else is three
    launches over ``n_chunks`` chunks with f32 scratch.  A block takes
    ``hb`` heads, which share its C B^T, and ``pb`` columns of P: the
    widest that fits shared memory, since a narrower slice forms C B^T
    again.  Blocks run one an SM, so the heads go into as many groups as
    fill the SMs once, to the nearest whole number (at least one group,
    at most a group per head).  Where that leaves one head a block and
    SMs still idle, ``pb`` narrows while the blocks still fit on the SMs:
    the serving engine's chunk is latency, not work.
    """
    n_chunks = _cdiv(S, _CHUNK)
    one = n_chunks == 1 and not with_state
    qr = min(_CHUNK, _cdiv(S, 16) * 16)

    def smem(pb, hb):
        if one:
            return _smem(qr, N, pb, hb, True, True, False)
        return max(_smem(qr, N, pb, hb, True, False, False),
                   _smem(qr, N, pb, hb, False, True, True))

    widths = [d for d in range(_MAX_PB, 0, -16) if P % d == 0]
    pb = next(d for d in widths if smem(d, 1) <= _SMEM_LIMIT)
    per_group = B * n_chunks * (P // pb)  # blocks of one head group
    n_hg = min(H, max(1, int(n_sm / per_group + 0.5)))
    while smem(pb, _cdiv(H, n_hg)) > _SMEM_LIMIT:
        n_hg += 1
    hb = _cdiv(H, n_hg)
    n_hg = _cdiv(H, hb)
    if hb == 1:
        pb = min((d for d in widths if d <= pb
                  and B * n_chunks * H * (P // d) <= n_sm), default=pb)
    blocks = B * n_chunks * n_hg * (P // pb)
    if one:
        return SSDPlan("one-chunk", _CHUNK, 1, hb, pb, blocks, 1, 0,
                       smem(pb, hb))
    return SSDPlan("multi-chunk", _CHUNK, n_chunks, hb, pb, blocks, 3,
                   4 * B * n_chunks * H * (P * N + 1), smem(pb, hb))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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

    CUDA tensors launch the kernels (``csrc/ssd_scan.cu``): bf16 the
    tensor-core route as :func:`ssd_plan` splits it, f32 the FP32-pipe
    kernel (TF32 would not hold f32 to its 3e-5).  CPU tensors run
    :func:`ssd_scan_plain`.  Calls count in ``ssd_scan.launches`` and, by
    route, in ``ssd_scan.launches_tc`` and ``launches_fp32``.  On CUDA
    the launch runs under autograd (``_SSDScan``): gradients flow to
    every input that requires them, by the plain version's backward.
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

    if P % _P_ALIGN or N % 8 or not 0 < N <= _MAX_N:
        raise ValueError(f"ssd_scan: head_dim P={P} must be a multiple of "
                         f"{_P_ALIGN}, and d_state N={N} a multiple of 8 up "
                         f"to {_MAX_N}")
    if Bsz == 0 or S == 0 or H == 0:
        raise ValueError(f"ssd_scan: empty input (B={Bsz}, S={S}, H={H}) "
                         f"has nothing to launch")
    return _SSDScan.apply(x_dt, Bm, Cm, log_a, initial_state)


def _launch(x_dt, Bm, Cm, log_a, initial_state):
    """The kernels on checked CUDA inputs; counts the launch."""
    Bsz, S, H, P = x_dt.shape
    N = Bm.shape[-1]
    dev = x_dt.device
    y = torch.empty_like(x_dt)
    h_out = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    st = dec = None
    hb = pb = 0
    tc = x_dt.dtype == torch.bfloat16
    if tc:
        plan = ssd_plan(Bsz, S, H, P, N, initial_state is not None,
                        _sm_count(index))
        hb, pb = plan.hb, plan.pb
        if plan.route == "multi-chunk":
            rows = Bsz * plan.n_chunks * H
            st = torch.empty(rows * P * N, dtype=torch.float32, device=dev)
            dec = torch.empty(rows, dtype=torch.float32, device=dev)
    err = _launcher()(
        index, DTYPE_CODES[x_dt.dtype], x_dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), log_a.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), h_out.data_ptr(),
        None if st is None else st.data_ptr(),
        None if dec is None else dec.data_ptr(), Bsz, S, H, P, N, hb, pb,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    if tc:
        ssd_scan.launches_tc += 1
    else:
        ssd_scan.launches_fp32 += 1
    return y, h_out


class _SSDScan(torch.autograd.Function):
    """The kernels under autograd.  The forward is the CUDA launch; the
    backward recomputes :func:`ssd_scan_plain` on the saved inputs and
    returns its input gradients: the reference trains through its own
    chunk loop (``models/ssm.py``), whose gradient this is, and has no
    backward kernel.  Only forwards launch, so only forwards count (a
    checkpointed layer's recompute is a forward and counts)."""

    @staticmethod
    def forward(ctx, x_dt, Bm, Cm, log_a, initial_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x_dt, Bm, Cm, log_a, initial_state)
        return _launch(x_dt, Bm, Cm, log_a, initial_state)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        wanted = [i for i, t in enumerate(saved)
                  if t is not None and ctx.needs_input_grad[i]]
        if not wanted or (gy is None and gh is None):
            return (None,) * len(saved)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted)
                      if t is not None else None
                      for i, t in enumerate(saved)]
            y, h = ssd_scan_plain(*inputs[:4], initial_state=inputs[4])
            outs = [(o, g) for o, g in ((y, gy), (h, gh)) if g is not None]
            grads = torch.autograd.grad(
                [o for o, _ in outs], [inputs[i] for i in wanted],
                [g for _, g in outs], allow_unused=True)
        out = [None] * len(saved)
        for i, g in zip(wanted, grads):
            out[i] = g
        return tuple(out)


ssd_scan.launches = 0
ssd_scan.launches_tc = 0  # bf16: mma.sync tensor-core kernels
ssd_scan.launches_fp32 = 0  # f32: FP32-pipe kernel
