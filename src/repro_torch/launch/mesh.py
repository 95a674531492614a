"""Hardware tables for the calibration's analytic terms.

``v5e_constants`` is the reference's TPU v5e table, kept bit for bit:
the roofline backend evaluates against it and must reproduce the
reference's samples exactly.  ``gpu_constants`` is the table of the CUDA
card being timed, keyed on its name, from NVIDIA's data sheets (dense
bf16 tensor-core rate, HBM bandwidth).  An unknown card raises: a
measured iteration time never mixes in another part's figures.

The production meshes of training (:func:`make_production_mesh`) are the
reference's shapes as :class:`repro_torch.compat.Mesh` records, which
hold no devices: the sharding rules read their axis sizes.

The sweep's cell placement lives here too, as in the reference: for
simulation the unit of parallelism is a grid cell (one (mix, policy, n,
seed) replication), and the batch engines split their cell batch over a
1-D list of devices (:func:`cells_mesh`, the reference's ``"cells"``
mesh axis).  :func:`shard_cells` is the raw primitive over that list
(strict -- the grid-level padding and tiling live in
:mod:`repro_torch.sweep.sharded`).
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Callable, Optional, Sequence, Union

import torch
from torch.utils import _pytree as pytree

from ..compat import Mesh, make_mesh

__all__ = ["CPU_STAND_IN", "GPU_TABLES", "cells_mesh", "gpu_constants",
           "gpu_table", "hw_record", "make_production_mesh", "shard_cells",
           "shard_cells_fn", "v5e_constants"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


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


def cells_mesh(n_devices: Optional[int] = None) -> list:
    """The 1-D list of CUDA devices a cell batch is split over.

    ``n_devices`` defaults to every visible card; pass a smaller count to
    leave cards free.  Raises when no CUDA device is visible: a host
    split takes an explicit list (e.g. ``["cpu"] * k``, as the tests do).
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cells_mesh: no CUDA device is visible; pass a device list "
            "(e.g. ['cpu'] * k) to split a batch on the host")
    avail = torch.cuda.device_count()
    d = avail if n_devices is None else int(n_devices)
    if not 1 <= d <= avail:
        raise ValueError(f"cells_mesh needs 1..{avail} devices, got {d}")
    return [torch.device("cuda", i) for i in range(d)]


def _to(tree, dev: torch.device):
    return pytree.tree_map(
        lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v, tree)


def shard_cells_fn(kernel: Callable, *, devices: Sequence) -> Callable:
    """The cell-split batch executable for ``kernel``.

    ``kernel(replicated, batched)`` computes a whole batch: every leaf
    of ``batched`` and of the returned pytree has the leading cell axis.
    The returned callable ``fn(replicated, batched)`` splits that axis
    evenly over ``devices``, in order: device j gets cells
    ``[j * per, (j + 1) * per)`` and its own copy of ``replicated``,
    runs ``kernel`` on them under its own CUDA context, and the outputs
    come back to the host (CPU tensors) concatenated in cell order.
    Devices are driven one after another from the calling thread.
    Strict by design: the cell count must divide by the device count
    (ragged grids are padded and tiled one layer up, in
    :mod:`repro_torch.sweep.sharded`).  Cells are independent in every
    kernel the port splits this way (``ctmc_scan``: a warp a
    replication; the engine's step: per-replication rows), which is
    what makes the result bitwise identical to one batch on one device.
    """
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("shard_cells needs >= 1 device")

    def fn(replicated, batched):
        leaves = pytree.tree_leaves(batched)
        if not leaves:
            raise ValueError("shard_cells got an empty batched pytree")
        n = int(leaves[0].shape[0])
        d = len(devs)
        if n % d != 0:
            raise ValueError(
                f"shard_cells is strict: {n} cells do not divide over "
                f"{d} devices (pad via repro_torch.sweep.sharded)")
        per = n // d
        parts = []
        for j, dev in enumerate(devs):
            part = pytree.tree_map(lambda v: v[j * per:(j + 1) * per],
                                   batched)
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                out = kernel(_to(replicated, dev), _to(part, dev))
                parts.append(_to(out, torch.device("cpu")))
        if d == 1:
            return parts[0]
        flat = [pytree.tree_flatten(p)[0] for p in parts]
        spec = pytree.tree_flatten(parts[0])[1]
        return pytree.tree_unflatten(
            [torch.cat(xs, 0) for xs in zip(*flat)], spec)

    return fn


def shard_cells(kernel: Callable, replicated, batched, *,
                devices: Sequence):
    """One-shot convenience wrapper over :func:`shard_cells_fn`."""
    return shard_cells_fn(kernel, devices=devices)(replicated, batched)
