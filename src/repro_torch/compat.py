"""Device selection for the port's entry points.

Every entry point that touches tensors takes a ``device`` argument and
resolves it here.  The default is the CUDA card: the port exists to run
on it, and a measurement that silently fell back to the CPU would be
reported as a device figure.  The CPU is used only when the caller asks
for it, as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` only when passed explicitly.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
