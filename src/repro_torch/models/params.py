"""Parameter declarations (shape + logical axis names + init rule), their
initialisation, their partition specs, and the carry-over of the
reference's weights.

:class:`PDef` and the tree walk are the reference's ``models/params``.
:func:`init_params` applies the reference's init rules with an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s);
:func:`params_from_numpy` takes a parameter tree as numpy arrays under
the reference's leaf paths (``seg0/b0/ssm/w_in``, ...), so the port can
compute with the very weights the JAX package made, and
:func:`train_state_from_numpy` does the same for a whole train state.
A single declaration drives both initialisation and the partition-spec
tree: :func:`partition_specs` maps each leaf's logical axes ("embed",
"heads", "ff", "vocab", "expert", ...) to mesh axes by a rules dict, as
plain tuples of mesh-axis names (the entries of the reference's
``PartitionSpec``); :func:`abstract_params` gives the tree as tensors on
the ``meta`` device, which hold shapes and no memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..compat import resolve_device

__all__ = ["DEFAULT_RULES", "PDef", "abstract_params", "init_params",
           "params_from_numpy", "partition_specs", "train_state_from_numpy",
           "tree_map", "tree_nbytes", "tree_unzip"]


@dataclass(frozen=True)
class PDef:
    shape: tuple
    axes: tuple  # logical axis per dim (str or None)
    init: str = "normal"  # normal | zeros | ones | const:<v>
    scale: Optional[float] = None  # stddev; default fan-in

    def stacked(self, n: int) -> "PDef":
        return PDef((n,) + tuple(self.shape), ("layer",) + tuple(self.axes),
                    self.init, self.scale)


#: Default logical->mesh axis rules (pure tensor-parallel over "model").
DEFAULT_RULES = {
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "q_lora": None,
    "kv_lora": None,
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ff": None,
    "layer": None,
    "state": None,
    "conv": None,
    "lru": "model",
    "frames": None,
}


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


def tree_flatten(tree, path=()):
    """(path, leaf) of every leaf of nested dicts and lists, in
    ``jax.tree.leaves`` order: dict keys sorted, a list's items as
    ``"[i]"``.  The optimizer's global norm and the checkpoints' leaf
    keys both walk in this order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten(v, path + (f"[{i}]",))
    else:
        yield path, tree


def tree_nbytes(tree) -> int:
    """Bytes the tensor leaves of a tree hold (``numel x element_size``)."""
    return sum(a.numel() * a.element_size() for _, a in tree_flatten(tree))


def tree_unzip(tree, n: int):
    """A dict tree whose leaves are n-tuples -> n dict trees (the
    reference's ``jax.tree.map(lambda t: t[i], ..., is_leaf=...)``)."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in parts} for i in range(n))
    return tree


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


def _tree_of(defs: dict, leaf) -> dict:
    """``leaf(pdef)`` at every leaf of ``defs``, in a tree of its paths."""
    out: dict = {}
    for path, d in _walk(defs):
        node = out
        for pkey in path[:-1]:
            node = node.setdefault(pkey, {})
        node[path[-1]] = leaf(d)
    return out


def partition_specs(defs: dict, rules: dict = None) -> dict:
    """The partition-spec tree matching ``defs`` under the logical-axis
    rules: per leaf, a tuple with one entry per dimension, the mesh axis
    (a name, a tuple of names, or None for replicated) its logical axis
    maps to."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    return _tree_of(defs, lambda d: tuple(rules.get(a) for a in d.axes))


def abstract_params(defs: dict, dtype=torch.float32) -> dict:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtype, no allocation (the dry run's lowering input)."""
    return _tree_of(defs, lambda d: torch.empty(tuple(d.shape), dtype=dtype,
                                                device="meta"))


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


def train_state_from_numpy(state: dict, device=None) -> dict:
    """A reference train state as numpy arrays (``{"params": ..., "opt":
    {"m": ..., "v": ..., "step": ...}}``, e.g. ``jax.tree.map(np.asarray,
    state)``) -> the same state as tensors on ``device``, every leaf in
    its own dtype: bf16 moments stay bf16, the step stays an int32
    scalar."""
    if set(state) != {"params", "opt"} \
            or set(state["opt"]) != {"m", "v", "step"}:
        raise ValueError("train_state_from_numpy needs {'params', 'opt': "
                         "{'m', 'v', 'step'}}")
    return params_from_numpy(state, device)
