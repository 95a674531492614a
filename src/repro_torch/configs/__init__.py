"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get_config(arch_id)`` returns the full published config;
``get_config(arch_id, reduced=True)`` the CPU-smoke-testable variant of the
same family.  The dry-run shape cells of the reference
(``repro.configs.shapes``) are not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

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

