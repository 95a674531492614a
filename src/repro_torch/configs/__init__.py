"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get_config(arch_id)`` returns the full published config;
``get_config(arch_id, reduced=True)`` the CPU-smoke-testable variant of the
same family.  Shapes live in :mod:`repro_torch.configs.shapes`.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, ShapeSpec, input_specs, skip_reason, supported_shapes

__all__ = ["ARCHS", "get_config", "SHAPES", "ShapeSpec", "input_specs",
           "skip_reason", "supported_shapes", "all_cells"]

#: arch id -> module name
ARCHS: dict[str, str] = {
    "whisper-base": "whisper_base",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-67b": "deepseek_67b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma2-2b": "gemma2_2b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-130m": "mamba2_130m",
    "paligemma-3b": "paligemma_3b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, including skipped ones."""
    return [(a, s) for a in ARCHS for s in SHAPES]
