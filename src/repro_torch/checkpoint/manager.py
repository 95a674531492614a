"""Sharded, atomic, keep-last-k checkpointing.

The reference's ``checkpoint/manager``, with its on-disk layout, so that
a checkpoint written by either package restores in the other, leaf for
leaf.  One directory per step:

    <root>/step_00000420/
        manifest.json      # leaf paths, shapes/dtypes, content hashes,
                           # host shard table, user metadata (data cursor...)
        host00.npz         # this host's leaves
        ...
    <root>/step_00000420.tmp_*   (staging; atomic rename on commit)

* **Atomicity** -- writes land in a ``.tmp`` staging dir; ``manifest.json``
  is written last and the directory is atomically renamed.  A crash never
  leaves a readable-but-corrupt checkpoint.
* **Per-host files** -- the host number is the ``torch.distributed`` rank
  (0 of 1 when no process group is up), the reference's process index.
* **Integrity** -- every leaf records a SHA256 of its bytes; restore
  verifies before placing the leaves on ``device``.
* **keep-last-k** -- bounded disk usage with ``gc()``.

bf16 leaves: numpy has no bfloat16 (the reference's comes from
``ml_dtypes``, which ``np.savez`` writes as raw 2-byte ``|V2`` words).
The port writes the bf16 words the same way, records ``"bfloat16"`` in
the manifest as the reference does, and rebuilds the tensor from the
16-bit words on restore.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..compat import resolve_device
from ..models.params import tree_flatten

__all__ = ["CheckpointManager"]


def _unflatten(items: dict):
    root: dict = {}
    for key, val in items.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.startswith("[") for k in node):
                return [listify(node[f"[{i}]"]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def _process() -> tuple[int, int]:
    """(rank, world size) of the default process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array ``np.savez`` writes, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device)


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3,
                 host_id: Optional[int] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host = host_id if host_id is not None else _process()[0]

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any,
             metadata: Optional[dict] = None) -> Path:
        """Save a tree of tensors (params / full train state) atomically."""
        final = self.root / f"step_{step:08d}"
        tmp = Path(tempfile.mkdtemp(prefix=final.name + ".tmp_",
                                    dir=self.root))
        arrays, manifest_leaves = {}, {}
        for path, leaf in tree_flatten(tree):
            key = "/".join(path)
            arr, dtype = _to_numpy(leaf)
            arrays[key] = arr
            manifest_leaves[key] = {
                "shape": list(arr.shape),
                "dtype": dtype,
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                "host": self.host,
            }
        np.savez(tmp / f"host{self.host:02d}.npz", **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": manifest_leaves,
            "metadata": metadata or {},
            "n_hosts": _process()[1],
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self.gc()
        return final

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.is_dir() and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int] = None, *, device=None,
                verify: bool = True) -> tuple[Any, dict]:
        """Load a checkpoint (the latest by default) onto ``device`` (the
        card unless ``"cpu"`` is asked for).  Returns (tree, metadata)."""
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        arrays: dict[str, np.ndarray] = {}
        for npz in sorted(d.glob("host*.npz")):
            with np.load(npz) as z:
                for k in z.files:
                    arrays[k] = z[k]
        if verify:
            for k, meta in manifest["leaves"].items():
                h = hashlib.sha256(arrays[k].tobytes()).hexdigest()
                if h != meta["sha256"]:
                    raise IOError(f"checkpoint corruption in leaf {k}")
        leaves = manifest["leaves"]
        tree = _unflatten({k: _to_tensor(v, leaves[k]["dtype"], device)
                           for k, v in arrays.items()})
        return tree, manifest["metadata"]

    # -------------------------------------------------------------------- gc
    def gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)
        # clean stale staging dirs
        for p in self.root.glob("step_*.tmp_*"):
            shutil.rmtree(p, ignore_errors=True)
