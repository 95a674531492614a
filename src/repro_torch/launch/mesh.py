"""Hardware tables for the calibration's analytic terms.

``v5e_constants`` is the reference's TPU v5e table, kept bit for bit:
the roofline backend evaluates against it and must reproduce the
reference's samples exactly.  ``gpu_constants`` is the table of the CUDA
card being timed, keyed on its name, from NVIDIA's data sheets (dense
bf16 tensor-core rate, HBM bandwidth).  An unknown card raises: a
measured iteration time never mixes in another part's figures.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

__all__ = ["CPU_STAND_IN", "GPU_TABLES", "gpu_constants", "gpu_table",
           "hw_record", "v5e_constants"]


def v5e_constants() -> dict:
    """TPU v5e per-chip hardware constants for the roofline terms."""
    return {
        "peak_flops_bf16": 197e12,  # FLOP/s
        "hbm_bw": 819e9,            # B/s
        "ici_link_bw": 50e9,        # B/s per link (~45-50 GB/s each way)
        "hbm_bytes": 16 * 1024**3,  # 16 GiB
        "ici_links": 4,             # 2D torus: 4 links per chip
    }


#: ``torch.cuda.get_device_properties(i).name`` -> (part, constants)
GPU_TABLES = {
    "NVIDIA H100 80GB HBM3": ("H100 SXM", {
        "peak_flops_bf16": 989e12,  # FLOP/s, dense
        "hbm_bw": 3.35e12,          # B/s
    }),
    "NVIDIA H100 PCIe": ("H100 PCIe", {
        "peak_flops_bf16": 756e12,
        "hbm_bw": 2.0e12,
    }),
}


def gpu_table(name: str) -> tuple:
    """``(part, constants)`` for a card name; raises on an unknown card."""
    if name not in GPU_TABLES:
        raise KeyError(f"no hardware table for GPU {name!r}; known: "
                       f"{sorted(GPU_TABLES)}")
    part, consts = GPU_TABLES[name]
    return part, dict(consts)


def gpu_constants(device: Optional[Union[int, str, torch.device]] = None
                  ) -> dict:
    """Data-sheet constants of the CUDA card ``device`` (default: current)."""
    return gpu_table(torch.cuda.get_device_properties(device).name)[1]


def _power_limit(index: int) -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


#: the table a kernels-backend run on the CPU carries in its record: no
#: card is timed there, so none of that run's numbers is a device figure
CPU_STAND_IN = "NVIDIA H100 80GB HBM3"


def hw_record(device: torch.device) -> dict:
    """The ``hw`` record of a kernels-backend calibration on ``device``.

    The constants of the table the analytic terms used, plus
    ``"table"`` (the part), ``"device"`` (the card's name, or ``"cpu"``)
    and, on a card, ``"power_limit"`` as ``nvidia-smi`` reports it.
    """
    if device.type != "cuda":
        part, consts = gpu_table(CPU_STAND_IN)
        return {**consts, "table": part, "device": "cpu"}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    name = torch.cuda.get_device_properties(index).name
    return {**gpu_constants(index), "table": gpu_table(name)[0],
            "device": name, "power_limit": _power_limit(index) or "unknown"}
