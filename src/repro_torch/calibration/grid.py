"""Calibration grid: the (batch B x prefill-chunk C x KV-tokens K) cells.

Two cell families, mirroring the paper's Fig. 3 measurement design:

* **mixed** cells ``(B, C, K0)`` vary the prefill chunk size ``C`` at a
  fixed baseline resident KV load ``K0`` -- these identify
  ``tau_mix(C) = alpha + beta * C``;
* **solo** cells ``(B, K)`` vary the aggregate resident KV tokens ``K``
  (spread over the ``B`` decode streams) -- these identify
  ``tau_solo(K) = a_s + b_s * K``.

``K`` is the *server-aggregate* KV residency (the quantity
``_Server.kv_tokens()`` tracks in the engine), not per-stream length.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

__all__ = ["CalibrationGrid", "GridCell"]


@dataclass(frozen=True)
class GridCell:
    """One timing cell; ``chunk == 0`` marks a decode-only (solo) cell."""

    mode: str  # "mixed" | "solo"
    batch: int
    chunk: int  # prefill chunk C (0 for solo cells)
    kv: int  # aggregate resident KV tokens K


@dataclass(frozen=True)
class CalibrationGrid:
    batch: Tuple[int, ...] = (8, 16)
    chunk: Tuple[int, ...] = (32, 64, 128, 256, 512)
    kv: Tuple[int, ...] = (256, 1024, 4096, 8192)
    kv_mixed: int = 1024  # baseline K during the mixed-cell chunk sweep

    def __post_init__(self) -> None:
        for name in ("batch", "chunk", "kv"):
            vals = getattr(self, name)
            if not vals or any(int(v) <= 0 for v in vals):
                raise ValueError(f"grid axis {name!r} needs positive entries")
            if list(vals) != sorted(set(int(v) for v in vals)):
                raise ValueError(
                    f"grid axis {name!r} must be strictly increasing")
        if len(self.chunk) < 2 or len(self.kv) < 2:
            raise ValueError("need >= 2 chunk and >= 2 kv points to "
                             "identify the affine slopes")
        if self.kv_mixed <= 0:
            raise ValueError("kv_mixed must be positive")

    @classmethod
    def default(cls) -> "CalibrationGrid":
        return cls()

    @classmethod
    def tiny(cls) -> "CalibrationGrid":
        """CPU-smoke grid (CI's ``calibration-smoke`` step)."""
        return cls(batch=(8,), chunk=(32, 64, 128), kv=(256, 1024, 2048),
                   kv_mixed=512)

    def mixed_cells(self) -> Iterator[GridCell]:
        for b in self.batch:
            for c in self.chunk:
                yield GridCell("mixed", int(b), int(c), int(self.kv_mixed))

    def solo_cells(self) -> Iterator[GridCell]:
        for b in self.batch:
            for k in self.kv:
                yield GridCell("solo", int(b), 0, int(k))

    def cells(self) -> Iterator[GridCell]:
        yield from self.mixed_cells()
        yield from self.solo_cells()

    @property
    def n_cells(self) -> int:
        return len(self.batch) * (len(self.chunk) + len(self.kv))

    # ------------------------------------------------------------- schema
    def to_dict(self) -> dict:
        return {"batch": list(self.batch), "chunk": list(self.chunk),
                "kv": list(self.kv), "kv_mixed": int(self.kv_mixed)}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationGrid":
        return cls(batch=tuple(int(v) for v in d["batch"]),
                   chunk=tuple(int(v) for v in d["chunk"]),
                   kv=tuple(int(v) for v in d["kv"]),
                   kv_mixed=int(d["kv_mixed"]))
