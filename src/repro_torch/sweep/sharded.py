"""Cell placement for the batched sweep engines over torch devices.

Every batched evaluator of the port reduces a grid of independent cells
-- (mix, policy, n, seed) replications for the simulators -- to "one
kernel, many leading-axis items".  This module places that leading axis
on devices behind one dispatch path (the reference's
``repro.sweep.sharded``, whose ``shard_map`` partitions a JAX device
mesh):

* ``placement="single"``    one kernel call per cell (debug / memory
  floor);
* ``placement="vmap"``      the whole batch in one call on one device --
  the **bitwise oracle** every other placement must reproduce exactly;
* ``placement="shard_map"`` the batch split over a 1-D list of devices
  (:func:`repro_torch.launch.mesh.cells_mesh`, every visible CUDA card
  by default) and looped through equal-shape tiles.  Each cell is
  independent in every kernel split this way (``ctmc_scan``: a warp a
  replication; the engine's step: one row a replication), so the result
  is bitwise identical to the vmap oracle at any device count and tile.

Three properties make the layer safe on arbitrary grids:

* **Device-count-agnostic random numbers** -- every cell's key derives
  from its *grid coordinates* (``cell_seed_sequence`` ->
  ``cell_int_seed`` -> ``prng_key``), never from its placement.
* **Padded-cell masking** -- a ragged batch is padded by repeating
  cell 0; the padded lanes compute real (discarded) work and the host
  slice ``[:n_cells]`` masks them out.
* **Memory-aware tiling** -- :func:`plan_shards` caps the cells
  resident per device (explicitly or from a ``bytes_per_cell`` /
  ``memory_budget`` estimate) and :func:`run_sharded` loops the batch
  through ``n_tiles`` equal-shape passes.  Equal shapes matter on the
  card: the engine's CUDA graphs are captured once per device and
  shape, not once per tile.

A ``shard_map`` request with no device list on a host without a CUDA
device raises; it never quietly runs ``vmap``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "PLACEMENTS",
    "ShardPlan",
    "plan_shards",
    "pad_batch",
    "run_sharded",
    "detected_devices",
]

# every way a batch engine can execute its cell batch; "vmap" is the
# single-device oracle, "shard_map" must match it bitwise
PLACEMENTS = ("single", "vmap", "shard_map")


def detected_devices() -> int:
    """Devices a default ``shard_map`` splits over: the visible CUDA
    cards."""
    return torch.cuda.device_count()


@dataclass(frozen=True)
class ShardPlan:
    """How one cell batch lays out over the devices.

    ``per_device`` cells sit on each of ``n_devices`` devices per pass,
    so one pass covers ``tile = n_devices * per_device`` cells and the
    batch takes ``n_tiles`` equal-shape passes; the final
    ``padded - n_cells`` lanes are padding, masked off on the host.
    """

    n_cells: int
    n_devices: int
    per_device: int

    def __post_init__(self) -> None:
        if self.n_cells < 1 or self.n_devices < 1 or self.per_device < 1:
            raise ValueError(f"degenerate shard plan: {self}")

    @property
    def tile(self) -> int:
        return self.n_devices * self.per_device

    @property
    def n_tiles(self) -> int:
        return -(-self.n_cells // self.tile)

    @property
    def padded(self) -> int:
        return self.n_tiles * self.tile

    @property
    def n_padding(self) -> int:
        return self.padded - self.n_cells

    def report(self) -> dict:
        return {
            "n_cells": self.n_cells, "n_devices": self.n_devices,
            "per_device": self.per_device, "tile": self.tile,
            "n_tiles": self.n_tiles, "n_padding": self.n_padding,
        }


def plan_shards(n_cells: int, *, n_devices: Optional[int] = None,
                max_cells_per_device: Optional[int] = None,
                bytes_per_cell: Optional[float] = None,
                memory_budget: Optional[float] = None) -> ShardPlan:
    """Tile a batch of ``n_cells`` over the devices.

    Default: one pass, ``per_device = ceil(n_cells / n_devices)``
    (``n_devices`` defaults to the visible CUDA cards).  A cap --
    ``max_cells_per_device`` directly, or derived as
    ``floor(memory_budget / bytes_per_cell)`` from a per-cell footprint
    estimate -- splits the batch into multiple equal-shape tiles so the
    per-device working set never exceeds the cap.
    """
    if n_cells < 1:
        raise ValueError(f"n_cells must be >= 1, got {n_cells}")
    d = int(n_devices) if n_devices is not None else detected_devices()
    cap = max_cells_per_device
    if bytes_per_cell is not None and memory_budget is not None:
        if bytes_per_cell <= 0:
            raise ValueError("bytes_per_cell must be positive")
        by_mem = max(1, int(memory_budget // bytes_per_cell))
        cap = by_mem if cap is None else min(int(cap), by_mem)
    per = -(-n_cells // d) if d >= 1 else 1
    if cap is not None:
        if cap < 1:
            raise ValueError(f"cell cap must be >= 1, got {cap}")
        per = min(per, int(cap))
    return ShardPlan(n_cells=int(n_cells), n_devices=d, per_device=per)


def _warn_serialized(n_devices: int) -> None:
    """Once per process: a shard_map placement that landed on one device
    is a correct but serial run.  Shares the ``"shard-serial"`` guard
    (:func:`repro_torch.compat.warn_once`), as the reference does, so
    the condition warns once no matter which layer detects it."""
    from repro_torch.compat import warn_once

    warn_once(
        "shard-serial",
        f"placement='shard_map' is running on a 1-device mesh "
        f"({n_devices} device): results are exact but the batch is not "
        f"partitioned -- pass more devices (cells_mesh(n) on a host with "
        f"n cards, or devices=[...])",
        stacklevel=4)


def pad_batch(batched, padded: int):
    """Pad every leaf of ``batched`` along axis 0 to length ``padded`` by
    repeating item 0 (a real cell: its padding lanes compute valid,
    discarded work, so no kernel ever sees out-of-distribution zeros)."""

    def pad(leaf):
        n = leaf.shape[0]
        if n == padded:
            return leaf
        reps = leaf[:1].expand((padded - n,) + tuple(leaf.shape[1:]))
        return torch.cat([leaf, reps], 0)

    return pytree.tree_map(pad, batched)


def run_sharded(kernel, replicated, batched, *,
                devices: Optional[Sequence] = None,
                plan: Optional[ShardPlan] = None,
                n_devices: Optional[int] = None,
                max_cells_per_device: Optional[int] = None,
                bytes_per_cell: Optional[float] = None,
                memory_budget: Optional[float] = None):
    """Evaluate ``kernel(replicated, cells)`` for every leading-axis item
    of the ``batched`` pytree, split over ``devices`` (default: the
    visible CUDA cards, :func:`repro_torch.launch.mesh.cells_mesh`).

    ``kernel`` computes a whole batch of cells (leading axis in and
    out).  Returns ``(raw, report)``: ``raw`` mirrors the kernel's
    output pytree with a leading axis of exactly ``n_cells`` (padding
    masked off, tiles concatenated on the host as CPU tensors),
    ``report`` is the :meth:`ShardPlan.report` dict plus the serialized
    flag (one device: a correct run that splits nothing, which also warns
    once per process).
    """
    from repro_torch.launch.mesh import cells_mesh, shard_cells_fn

    leaves = pytree.tree_leaves(batched)
    if not leaves:
        raise ValueError("run_sharded got an empty batched pytree")
    n_cells = int(leaves[0].shape[0])
    if devices is None:
        devices = cells_mesh(n_devices if plan is None else plan.n_devices)
    devices = [torch.device(d) for d in devices]
    if plan is None:
        plan = plan_shards(n_cells, n_devices=len(devices),
                           max_cells_per_device=max_cells_per_device,
                           bytes_per_cell=bytes_per_cell,
                           memory_budget=memory_budget)
    elif plan.n_cells != n_cells:
        raise ValueError(f"plan is for {plan.n_cells} cells, batch has "
                         f"{n_cells}")
    if plan.n_devices != len(devices):
        raise ValueError(f"plan is for {plan.n_devices} devices, "
                         f"{len(devices)} given")
    if plan.n_devices == 1:
        _warn_serialized(plan.n_devices)

    fn = shard_cells_fn(kernel, devices=devices)
    full = pad_batch(batched, plan.padded)
    tiles = []
    for t in range(plan.n_tiles):
        sl = slice(t * plan.tile, (t + 1) * plan.tile)
        tiles.append(fn(replicated,
                        pytree.tree_map(lambda leaf: leaf[sl], full)))
    flat = [pytree.tree_flatten(o)[0] for o in tiles]
    spec = pytree.tree_flatten(tiles[0])[1]
    raw = pytree.tree_unflatten(
        [torch.cat(xs, 0)[:n_cells] for xs in zip(*flat)], spec)
    report = dict(plan.report(), serialized=bool(plan.n_devices == 1))
    return raw, report
