"""Versioned JSON calibration artifact.

A :class:`CalibrationArtifact` is the full provenance of one calibration
run: the grid, every raw timing sample, both fitted surfaces with their
diagnostics, and the hardware constants in force.  JSON serialisation is
*lossless* -- floats go through Python's shortest-round-trip repr, so
``from_json(to_json(a)) == a`` exactly (a property test pins this).

Schema versioning: ``schema_version`` is written into every artifact and
checked on load; bump :data:`SCHEMA_VERSION` on any breaking layout
change.  The layout is the reference's, so an artifact the reference
wrote loads here unchanged.  A kernels-backend artifact of this package
also names, in ``hw``, the hardware table (``"table"``), the device
(``"device"``: the card's name, or ``"cpu"``) and the card's
``"power_limit"``; these are the only string values in ``hw``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple, Union

from repro_torch.core.types import ServicePrimitives

from .fit import AffineFit
from .grid import CalibrationGrid
from .measure import Sample

__all__ = ["SCHEMA_VERSION", "CalibrationArtifact"]

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class CalibrationArtifact:
    """One calibration run: grid + raw samples + fitted surfaces."""

    arch: str
    backend: str  # "kernels" | "roofline"
    grid: CalibrationGrid
    samples: Tuple[Sample, ...]
    mix: AffineFit  # tau_mix(C):  alpha = intercept, beta = slope
    solo: AffineFit  # tau_solo(K): a_s = intercept,  b_s = slope
    hw: Dict[str, Union[float, str]]
    created: str = ""  # ISO timestamp, caller-supplied (may be empty)
    schema_version: int = SCHEMA_VERSION

    # ------------------------------------------------------ paper names
    @property
    def alpha(self) -> float:
        return self.mix.intercept

    @property
    def beta(self) -> float:
        return self.mix.slope

    @property
    def a_s(self) -> float:
        return self.solo.intercept

    @property
    def b_s(self) -> float:
        return self.solo.slope

    @property
    def min_r2(self) -> float:
        return min(self.mix.r2, self.solo.r2)

    def primitives(self, *, batch_cap: int = 16,
                   chunk: int = 256) -> ServicePrimitives:
        """Project the fitted surfaces onto the queueing-model constants.

        ``gamma = 1 / a_s`` evaluates tau_solo at ``K = 0``; the KV slope
        ``b_s`` lives outside :class:`ServicePrimitives` (the engines
        carry it separately) and is exposed via :attr:`b_s`.
        """
        return ServicePrimitives(alpha=self.alpha, beta=self.beta,
                                 gamma=1.0 / self.a_s,
                                 batch_cap=batch_cap, chunk=chunk)

    # ----------------------------------------------------------- (de)ser
    def to_dict(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "arch": self.arch,
            "backend": self.backend,
            "created": self.created,
            "grid": self.grid.to_dict(),
            "samples": [s.to_dict() for s in self.samples],
            "fits": {"mix": self.mix.to_dict(), "solo": self.solo.to_dict()},
            "hw": dict(self.hw),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationArtifact":
        ver = int(d.get("schema_version", -1))
        if ver != SCHEMA_VERSION:
            raise ValueError(
                f"calibration artifact schema_version {ver} != supported "
                f"{SCHEMA_VERSION}; re-run the calibration")
        return cls(
            arch=str(d["arch"]),
            backend=str(d["backend"]),
            grid=CalibrationGrid.from_dict(d["grid"]),
            samples=tuple(Sample.from_dict(s) for s in d["samples"]),
            mix=AffineFit.from_dict(d["fits"]["mix"]),
            solo=AffineFit.from_dict(d["fits"]["solo"]),
            hw={k: v if isinstance(v, str) else float(v)
                for k, v in d["hw"].items()},
            created=str(d.get("created", "")),
            schema_version=ver,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationArtifact":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path) -> "CalibrationArtifact":
        return cls.from_json(Path(path).read_text())
