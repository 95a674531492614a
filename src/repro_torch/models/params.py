"""Parameter declarations: shape + logical axis names + init rule.

The shape half of the reference's ``models/params``: :class:`PDef` and
the tree walk.  Initialisation and sharding specs come with the forwards
(ROADMAP A10); the leaf paths (``seg0/b0/attn/wq``, ...) are the
reference's, so a weight converter can map keys one to one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["PDef"]


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
