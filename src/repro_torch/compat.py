"""Device selection for the port's entry points.

Every entry point that touches tensors takes a ``device`` argument and
resolves it here.  The default is the CUDA card: the port exists to run
on it, and a measurement that silently fell back to the CPU would be
reported as a device figure.  The CPU, or the ``meta`` device that the
dry run traces on, is used only when the caller asks for it, as the
tests do.

Precision is explicit: where the reference reads the process-wide
``jax_enable_x64`` flag (``jnp.result_type(float)``), the port's entry
points take a ``dtype`` argument instead.

Also here, as in the reference's ``compat``: the once-per-process
warning guard (:func:`warn_once`) and :func:`make_mesh`, which builds the
shape-only :class:`Mesh` that the sharding rules read.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Union

import torch

__all__ = ["Mesh", "make_mesh", "prng_key", "reset_warn_once",
           "resolve_device", "warn_once"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` or ``"meta"`` (shapes without
    data: the dry run's trace) only when passed explicitly.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
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


# Process-wide once-per-kind warning guard, the reference's: the layers
# that detect one condition (a "sharded" run that is serial on one device)
# share a ``kind``, so a sweep warns once per process, not once per layer
# per call.  Tests re-arm a kind with ``reset_warn_once``.
_warned_once: set = set()


def warn_once(kind: str, message: str, *, stacklevel: int = 3) -> bool:
    """Emit ``message`` as a RuntimeWarning the first time ``kind`` is seen.

    Returns True if the warning fired, False if ``kind`` already warned
    in this process.
    """
    if kind in _warned_once:
        return False
    _warned_once.add(kind)
    warnings.warn(message, RuntimeWarning, stacklevel=stacklevel + 1)
    return True


def reset_warn_once(kind: Optional[str] = None) -> None:
    """Re-arm the once-per-kind guard (all kinds when ``kind`` is None)."""
    if kind is None:
        _warned_once.clear()
    else:
        _warned_once.discard(kind)


@dataclass(frozen=True)
class Mesh:
    """A named device mesh as a shape only: ``shape`` maps each axis name
    to its size, in ``axis_names`` order.  It holds no devices, so the
    production meshes (256 and 512 chips) can be built and reasoned about
    on any host; the sharding rules (``training.sharding``) and the
    partition specs read only the sizes."""

    shape: dict
    axis_names: tuple


def make_mesh(shape, axis_names) -> Mesh:
    """The counterpart of ``repro.compat.make_mesh``: a :class:`Mesh` of
    ``shape`` over ``axis_names`` (no devices are looked up)."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"make_mesh needs one distinct name per axis, got "
                         f"shape {shape} and names {axis_names}")
    return Mesh(dict(zip(axis_names, shape)), axis_names)
