"""Timing backends for the calibration grid.

Two backends produce ``tau`` (seconds per engine iteration) for a grid
cell:

* ``"kernels"`` -- times the port's own CUDA kernels through their
  public :mod:`repro_torch.kernels` ``ops`` wrappers on the card (CUDA
  events, warmup + median of ``reps``), and adds the analytic
  weight-streaming and launch-overhead terms the attention kernels alone
  cannot see, from the timed card's own hardware table
  (:func:`repro_torch.launch.mesh.gpu_constants`).  With
  ``device="cpu"`` the same control flow runs the kernels' plain
  versions under a host clock; such an artifact is marked
  ``hw["device"] == "cpu"`` and none of its numbers is a device figure.
* ``"roofline"`` -- fully deterministic closed-form fallback: per-
  iteration FLOPs and HBM bytes from the :class:`ModelConfig` shape math
  against ``mesh.v5e_constants``, bit for bit the reference's.  The
  *additive* roofline sum (compute + memory + overhead, not the max)
  keeps the surface exactly affine in ``C`` and ``K``, so the fitter's
  R^2 diagnostic is meaningful and the no-accelerator path is
  reproducible bit-for-bit.

``backend="auto"`` picks ``"kernels"`` when CUDA is present and
``"roofline"`` elsewhere.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.launch.mesh import v5e_constants
from repro_torch.telemetry.timing import timeit_median, timeit_median_cuda

from .grid import CalibrationGrid, GridCell

__all__ = [
    "DEFAULT_OVERHEAD_S",
    "Sample",
    "collect_samples",
    "iteration_costs",
    "resolve_backend",
    "roofline_tau",
    "timeit_median",
]

# Fixed per-iteration launch/dispatch overhead for the analytic backend.
# Chosen at the scale of the paper's measured A100 intercepts (Sec. 6.2:
# alpha = 17.4 ms includes scheduler + launch cost the roofline terms
# cannot see); the exact value only shifts the fitted intercepts, never
# the slopes or the fit quality.
DEFAULT_OVERHEAD_S = 2e-3


@dataclass(frozen=True)
class Sample:
    """One timed grid cell."""

    mode: str  # "mixed" | "solo"
    batch: int
    chunk: int  # prefill chunk C (0 for solo)
    kv: int  # aggregate resident KV tokens K
    tau: float  # seconds per iteration
    backend: str  # "kernels" | "roofline"

    def to_dict(self) -> dict:
        return {"mode": self.mode, "batch": self.batch, "chunk": self.chunk,
                "kv": self.kv, "tau": self.tau, "backend": self.backend}

    @classmethod
    def from_dict(cls, d: dict) -> "Sample":
        return cls(mode=str(d["mode"]), batch=int(d["batch"]),
                   chunk=int(d["chunk"]), kv=int(d["kv"]),
                   tau=float(d["tau"]), backend=str(d["backend"]))


# --------------------------------------------------------------- analytic
def _dtype_bytes(cfg) -> int:
    return 2 if cfg.param_dtype == "bfloat16" else 4


def _attn_layer_stats(cfg) -> Dict[str, float]:
    """Per-attention-layer width and KV-cache bytes per resident token."""
    n_attn = d_attn = kv_bytes = 0
    specs = cfg.block_specs()
    el = 1 if cfg.kv_quant else _dtype_bytes(cfg)
    for s in specs:
        if s.mixer in ("attn", "attn_local"):
            n_attn += 1
            d_attn = cfg.attn.n_heads * cfg.attn.head_dim
            kv_bytes = 2 * cfg.attn.n_kv_heads * cfg.attn.head_dim * el
            if cfg.kv_quant:  # per-(token, kv-head) fp32 scales, K and V
                kv_bytes += 2 * cfg.attn.n_kv_heads * 4
        elif s.mixer == "mla":
            n_attn += 1
            d_attn = cfg.mla.n_heads * (cfg.mla.qk_nope_dim
                                        + cfg.mla.qk_rope_dim)
            kv_bytes = (cfg.mla.kv_lora_rank
                        + cfg.mla.qk_rope_dim) * _dtype_bytes(cfg)
        # ssm / rec layers carry O(1) state: no per-token KV growth
    return {"n_attn": n_attn, "d_attn": d_attn, "kv_bytes": kv_bytes}


def iteration_costs(cfg, *, tokens: int, kv_tokens: int) -> Dict[str, float]:
    """Closed-form FLOPs and HBM bytes for one engine iteration.

    ``tokens`` = tokens computed this iteration (prefill chunk + one per
    decode stream); ``kv_tokens`` = aggregate resident KV tokens across
    the batch.  Both terms are *linear* in their argument by
    construction, which is exactly the paper's affine-surface claim.
    """
    from repro_torch.models.model import active_param_count

    n_active = active_param_count(cfg)
    st = _attn_layer_stats(cfg)
    flops = 2.0 * n_active * tokens + 4.0 * st["d_attn"] * st["n_attn"] * kv_tokens
    bytes_ = (float(n_active) * _dtype_bytes(cfg)
              + float(st["kv_bytes"]) * kv_tokens)
    return {"flops": flops, "bytes": bytes_}


def roofline_tau(cfg, *, tokens: int, kv_tokens: int,
                 hw: Optional[dict] = None,
                 overhead_s: float = DEFAULT_OVERHEAD_S) -> float:
    """Deterministic analytic iteration time (additive roofline sum)."""
    hw = hw or v5e_constants()
    c = iteration_costs(cfg, tokens=tokens, kv_tokens=kv_tokens)
    return (overhead_s + c["flops"] / hw["peak_flops_bf16"]
            + c["bytes"] / hw["hbm_bw"])


def _cell_tokens(cell: GridCell) -> int:
    # mixed iteration computes the prefill chunk plus one token per
    # decode stream; a solo iteration computes one token per stream.
    return cell.chunk + cell.batch if cell.mode == "mixed" else cell.batch


# ---------------------------------------------------------------- kernels
def _time_kernels_cell(cfg, cell: GridCell, *, reps: int,
                       device: torch.device, hw: dict) -> float:
    """Card path: CUDA attention kernels + analytic rest.

    The attention ops see the cell's exact (C, K) shapes; the dense
    weight-stream and launch-overhead terms (shape-independent of C and
    K at fixed batch) come from the same closed form as the roofline
    backend, against ``hw`` (the timed card's table), so both backends
    fit commensurable surfaces.
    """
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    if cfg.attn is None:
        raise ValueError(
            f"kernel backend needs an attention config (model "
            f"{cfg.name!r} has none); use backend='roofline'")
    H, KV, D = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    B = cell.batch
    gen = torch.Generator(device=device).manual_seed(0)
    dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dt, device=device)

    timer = timeit_median_cuda if device.type == "cuda" else timeit_median
    # per-stream cache length covering the aggregate K
    S = max(1, math.ceil(cell.kv / B))
    qd, kc, vc = randn(B, 1, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
    kv_len = torch.full((B,), S, dtype=torch.int32, device=device)
    tau = timer(lambda: decode_attention(qd, kc, vc, kv_len), reps=reps)

    if cell.mode == "mixed" and cell.chunk > 0:
        qp = randn(1, cell.chunk, H, D)
        kp = randn(1, cell.chunk, KV, D)
        tau += timer(lambda: prefill_attention(qp, kp, kp), reps=reps)

    # analytic weight-stream + launch terms (attention already measured)
    from repro_torch.models.model import active_param_count
    n_active = active_param_count(cfg)
    tau += (DEFAULT_OVERHEAD_S
            + 2.0 * n_active * _cell_tokens(cell) / hw["peak_flops_bf16"]
            + float(n_active) * _dtype_bytes(cfg) / hw["hbm_bw"])
    return tau


def resolve_backend(backend: str) -> str:
    if backend != "auto":
        return backend
    return "kernels" if torch.cuda.is_available() else "roofline"


def collect_samples(grid: CalibrationGrid, cfg, *, backend: str = "auto",
                    reps: int = 5, device: Optional[torch.device] = None,
                    hw: Optional[dict] = None) -> List[Sample]:
    """Time every grid cell; returns one :class:`Sample` per cell.

    The kernels backend needs the resolved ``device`` and its hardware
    record ``hw`` (:func:`repro_torch.launch.mesh.hw_record`).
    """
    backend = resolve_backend(backend)
    if backend not in ("kernels", "roofline"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernels" and (device is None or hw is None):
        raise ValueError("the kernels backend needs device= and hw=")
    out: List[Sample] = []
    for cell in grid.cells():
        if backend == "kernels":
            tau = _time_kernels_cell(cfg, cell, reps=reps, device=device,
                                     hw=hw)
        else:
            tau = roofline_tau(cfg, tokens=_cell_tokens(cell),
                               kv_tokens=cell.kv)
        out.append(Sample(mode=cell.mode, batch=cell.batch, chunk=cell.chunk,
                          kv=cell.kv, tau=tau, backend=backend))
    return out
