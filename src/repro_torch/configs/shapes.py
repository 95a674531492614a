"""Assigned input shapes and their meta-tensor stand-ins.

Four shapes per LM architecture (40 cells across the 10 archs):

* ``train_4k``     seq 4,096  x global_batch 256   -> traces train_step
* ``prefill_32k``  seq 32,768 x global_batch 32    -> traces prefill_step
* ``decode_32k``   seq 32,768 x global_batch 128   -> traces serve_step
                   (one new token, KV cache of seq_len)
* ``long_500k``    seq 524,288 x global_batch 1    -> serve_step; only for
                   sub-quadratic archs (ssm / hybrid / local-attn hybrids)

``input_specs`` returns tensors on PyTorch's ``meta`` device for every
model input of the step being traced, including stub modality frontends
(audio frames / vision patches): they carry shape and dtype and allocate
nothing, the counterpart of the reference's ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "supported_shapes", "input_specs",
           "skip_reason"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    """None if the (arch, shape) cell runs; else a one-line skip reason."""
    s = SHAPES[shape]
    if s.name == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return None


def supported_shapes(cfg: ModelConfig) -> list[str]:
    return [k for k in SHAPES if skip_reason(cfg, k) is None]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _stub_specs(cfg: ModelConfig, batch: int) -> dict:
    out = {}
    if cfg.encoder is not None:
        out["enc_frames"] = _meta(
            (batch, cfg.encoder.n_frames, cfg.encoder.d_model), torch.bfloat16)
    if cfg.vision is not None:
        out["prefix_embeds"] = _meta(
            (batch, cfg.vision.n_patches, cfg.d_model), torch.bfloat16)
    return out


def input_specs(cfg: ModelConfig, shape: str, *,
                global_batch: int | None = None) -> dict:
    """Meta-tensor stand-ins for the data inputs of the traced step."""
    s = SHAPES[shape]
    gb = global_batch if global_batch is not None else s.global_batch
    if s.kind == "train":
        specs = {
            "tokens": _meta((gb, s.seq_len), torch.int32),
            "labels": _meta((gb, s.seq_len), torch.int32),
        }
        specs.update(_stub_specs(cfg, gb))
        return specs
    if s.kind == "prefill":
        specs = {
            "tokens": _meta((gb, s.seq_len), torch.int32),
            "positions": _meta((gb, s.seq_len), torch.int32),
        }
        specs.update(_stub_specs(cfg, gb))
        return specs
    # decode: one new token against a seq_len KV cache
    return {
        "tokens": _meta((gb, 1), torch.int32),
        "positions": _meta((gb,), torch.int32),
    }
