"""Logical-axis -> mesh-axis rules, with automatic divisibility fallback.

The reference's ``training/sharding``, over the shape-only
:class:`repro_torch.compat.Mesh`.  Strategy: tensor-parallel over the
mesh "model" axis (heads / ff / vocab / expert), FSDP over "data" (and
optionally "pod") on the "embed" axis, batch over ("pod","data").  Any
logical axis whose dimension is not divisible by its mesh-axis size
*anywhere* in the def tree is demoted to replicated -- this is what lets
14-head / odd-vocab archs share one rule set.

Specs are tuples of mesh-axis names, one entry per dimension (the
entries of the reference's ``PartitionSpec``).  One card holds every
leaf whole, so :func:`state_shardings` describes a layout (the mesh and
the spec of each leaf) and places nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..compat import Mesh
from ..models.params import DEFAULT_RULES, _walk, partition_specs

__all__ = ["NamedSharding", "make_rules", "batch_spec", "state_shardings",
           "auto_demote"]


class NamedSharding(NamedTuple):
    """A leaf's layout: the mesh and its spec over the mesh's axes."""

    mesh: Mesh
    spec: tuple


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return int(mesh.shape[axis])


def make_rules(mesh: Mesh, *, fsdp: bool = True,
               fsdp_axis="data", overrides: dict | None = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if fsdp:
        # FSDP shards the "embed" axis; expert_ff stays replicated (expert
        # weights are already 2D-sharded via expert x embed).
        rules["embed"] = fsdp_axis
    if overrides:
        rules.update(overrides)
    return rules


def auto_demote(defs: dict, rules: dict, mesh: Mesh) -> dict:
    """Replicate any logical axis that does not divide everywhere it occurs."""
    bad: set[str] = set()
    for _, d in _walk(defs):
        for dim, ax in zip(d.shape, d.axes):
            if ax is None or rules.get(ax) is None:
                continue
            if dim % _axis_size(mesh, rules[ax]) != 0:
                bad.add(ax)
    out = dict(rules)
    for ax in bad:
        out[ax] = None
    return out


def batch_spec(mesh: Mesh) -> tuple:
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return (tuple(axes) if len(axes) > 1 else axes[0],)


def state_shardings(defs: dict, mesh: Mesh, rules: dict) -> dict:
    """A :class:`NamedSharding` per leaf of ``defs``, for params and AdamW
    moments alike (same layout)."""
    def to_ns(node):
        if isinstance(node, dict):
            return {k: to_ns(v) for k, v in node.items()}
        return NamedSharding(mesh, node)

    return to_ns(partition_specs(defs, rules))
