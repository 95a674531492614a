"""Parameter declarations (shape + logical axis names + init rule), their
initialisation, and the carry-over of the reference's weights.

:class:`PDef` and the tree walk are the reference's ``models/params``.
:func:`init_params` applies the reference's init rules with an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s);
:func:`params_from_numpy` takes a parameter tree as numpy arrays under
the reference's leaf paths (``seg0/b0/ssm/w_in``, ...), so the port can
compute with the very weights the JAX package made.  Sharding specs are
not ported (ROADMAP A12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..compat import resolve_device

__all__ = ["PDef", "init_params", "params_from_numpy", "tree_map"]


@dataclass(frozen=True)
class PDef:
    shape: tuple
    axes: tuple  # logical axis per dim (str or None)
    init: str = "normal"  # normal | zeros | ones | const:<v>
    scale: Optional[float] = None  # stddev; default fan-in

    def stacked(self, n: int) -> "PDef":
        return PDef((n,) + tuple(self.shape), ("layer",) + tuple(self.axes),
                    self.init, self.scale)


def _walk(defs, path=()):
    for k, v in defs.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (``jax.tree.map``
    for the port's parameter and cache trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _init_leaf(generator: torch.Generator, d: PDef, dtype, device):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "normal":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        z = torch.randn(d.shape, generator=generator, device=generator.device)
        # scaled in place: one f32 copy of the leaf at a time
        return z.mul_(float(scale)).to(device=device, dtype=dtype)
    if d.init.startswith("const:"):
        return torch.full(d.shape, float(d.init.split(":")[1]), dtype=dtype,
                          device=device)
    raise ValueError(d.init)


def init_params(defs: dict, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Initialise a (nested) dict of PDefs into a matching dict of tensors.

    ``normal`` leaves are drawn from ``generator`` (on its own device) in
    the order of the tree walk; leaves named ``*_f32`` with a constant
    init stay float32, as in the reference.
    """
    device = resolve_device(device)
    out: dict = {}
    for path, d in _walk(defs):
        node = out
        for pkey in path[:-1]:
            node = node.setdefault(pkey, {})
        leaf_dtype = dtype
        if d.init in ("zeros", "ones") or d.init.startswith("const:"):
            leaf_dtype = torch.float32 if path[-1].endswith("_f32") else dtype
        node[path[-1]] = _init_leaf(generator, d, leaf_dtype, device)
    return out


def _leaf_from_numpy(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot wrap
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device=None, dtype=None):
    """A parameter tree of numpy arrays (the reference's leaf paths) ->
    the same tree of tensors on ``device``, cast to ``dtype`` if given."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, device, dtype), tree)
