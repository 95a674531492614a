"""Device selection for the port's entry points.

Every entry point that touches tensors takes a ``device`` argument and
resolves it here.  The default is the CUDA card: the port exists to run
on it, and a measurement that silently fell back to the CPU would be
reported as a device figure.  The CPU is used only when the caller asks
for it, as the tests do.

Precision is explicit: where the reference reads the process-wide
``jax_enable_x64`` flag (``jnp.result_type(float)``), the port's entry
points take a ``dtype`` argument instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["prng_key", "resolve_device"]


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


def prng_key(seed: int) -> torch.Tensor:
    """The key of the port's counter-based generator (Philox4x32-10) for a
    host int seed: its two 32-bit words ``(lo, hi)`` of ``seed mod 2**64``,
    as an int64 tensor of shape (2,) on the CPU.

    The counterpart of ``repro.compat.prng_key``.  The streams differ from
    JAX's threefry streams on the same seed, so the port is held to the
    reference statistically where it draws random numbers.
    """
    s = int(seed) % (1 << 64)
    return torch.tensor([s & 0xFFFFFFFF, s >> 32], dtype=torch.int64)
