"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

#: element type -> the number the CUDA entry points take (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_tensors(where: str, *tensors: torch.Tensor) -> None:
    """Same device and dtype, a supported dtype, contiguous; on CUDA also
    16-byte aligned (the kernels load 16 bytes at a time)."""
    t0 = tensors[0]
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"{where}: dtype {t0.dtype} not supported "
                        f"(have {list(DTYPE_CODES)})")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{where}: all inputs need one device and dtype, "
                             f"got {t.device}/{t.dtype} and "
                             f"{t0.device}/{t0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: inputs must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{where}: CUDA inputs must be 16-byte aligned")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{where}: unsupported device {t0.device}")


def refuse_grad(where: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need this function's backward: it has
    none, in the reference or here, and a result without ``grad_fn``
    would drop the gradient without a word.  Checked on every device, so
    the plain version on the CPU refuses what the kernel would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{where} has no backward: call it under torch.no_grad() or on "
            f"inputs that do not require grad (training attends through "
            f"models.attention.blockwise_attention)")


def check_launch(where: str, err: int) -> None:
    """Raise on the ``cudaError_t`` a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{where}: CUDA launch failed with cudaError {err}")
