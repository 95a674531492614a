"""Schema-versioned run manifests (``RunRecord`` JSONL) of the port.

Every artifact-producing entry point of the port -- the sweep runner and
its CLI, ``run_closed_loop`` -- emits one :func:`run_record` describing
*how* its outputs were produced: git SHA, the torch, CUDA and numpy
versions, the card it ran on, placement/evaluator, spec hash, wall-clock
and sha256 digests of the artifacts written.  Records append to
``artifacts/manifests_torch/runs.jsonl`` (one JSON object per line), a
file of the port's own: the reference's ``repro.telemetry.manifest``
keeps ``artifacts/manifests/runs.jsonl`` and a key set with
``jax_version``, and neither validator accepts the other's records.

The schema is hand-validated (:func:`validate_record`) and versioned by
``MANIFEST_SCHEMA_VERSION``.  ``payload_digest`` and ``file_digest`` are
the reference's, byte for byte: ``payload_digest`` hashes the
*canonical* JSON form of a payload with its ``"manifest"`` key removed,
so the embedded record never hashes itself.
"""

from __future__ import annotations

import hashlib
import json
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Iterable, Optional

import torch

__all__ = [
    "MANIFEST_SCHEMA_VERSION",
    "append_record",
    "default_manifest_path",
    "file_digest",
    "git_sha",
    "payload_digest",
    "read_records",
    "run_record",
    "validate_record",
]

MANIFEST_SCHEMA_VERSION = 1

# required key -> allowed types (None allowed where recorded as nullable)
_SCHEMA = {
    "schema_version": (int,),
    "kind": (str,),
    "name": (str,),
    "created_unix": (int, float),
    "git_sha": (str, type(None)),
    "torch_version": (str,),
    "cuda_version": (str, type(None)),
    "device_name": (str, type(None)),
    "numpy_version": (str, type(None)),
    "python": (str,),
    "platform": (str,),
    "wall_s": (int, float, type(None)),
    "extra": (dict,),
    "artifacts": (dict,),
}
_KINDS = ("bench", "sweep", "closed_loop", "telemetry")


def git_sha(root: Optional[Path] = None) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, check=True, timeout=10)
        sha = out.stdout.strip()
        return sha or None
    except (OSError, subprocess.SubprocessError):
        return None


def payload_digest(payload: dict) -> str:
    """sha256 of the canonical JSON form, ``"manifest"`` key excluded
    (so a digest embedded next to the record stays self-consistent)."""
    body = {k: v for k, v in payload.items() if k != "manifest"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"),
                      default=float)
    return hashlib.sha256(blob.encode()).hexdigest()


def file_digest(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _numpy_version() -> Optional[str]:
    try:
        import numpy
        return str(numpy.__version__)
    except ImportError:
        return None


def _device_name(device) -> Optional[str]:
    """The card's name as ``nvidia-smi`` reports it (the name torch
    reports when ``nvidia-smi`` cannot be run); None off the card."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        name = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        name = ""
    return name or torch.cuda.get_device_name(index)


def run_record(*, kind: str, name: str, wall_s: Optional[float] = None,
               extra: Optional[dict] = None,
               artifacts: Optional[dict] = None,
               root: Optional[Path] = None, device=None) -> dict:
    """One schema-versioned RunRecord.

    ``kind`` is the producing subsystem (one of ``bench``, ``sweep``,
    ``closed_loop``, ``telemetry``); ``extra`` carries free-form
    provenance (placement, evaluator, spec hash, payload digest...);
    ``artifacts`` maps artifact paths to their sha256 digests;
    ``device`` is where the run computed (``device_name`` is the card's
    name, or null for the CPU or a run that touched no device).
    """
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    return {
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "kind": kind,
        "name": str(name),
        "created_unix": time.time(),
        "git_sha": git_sha(root),
        "torch_version": str(torch.__version__),
        "cuda_version": torch.version.cuda,
        "device_name": _device_name(device),
        "numpy_version": _numpy_version(),
        "python": platform.python_version(),
        "platform": f"{sys.platform}-{platform.machine()}",
        "wall_s": None if wall_s is None else float(wall_s),
        "extra": dict(extra or {}),
        "artifacts": {str(k): str(v)
                      for k, v in (artifacts or {}).items()},
    }


def validate_record(record) -> list:
    """Schema check; returns a list of error strings (empty = valid).

    A key outside the port's schema is an error too: a record of the
    reference (``jax_version``, no ``torch_version``) never passes."""
    errors = []
    if not isinstance(record, dict):
        return [f"record must be a JSON object, got "
                f"{type(record).__name__}"]
    for key, types in _SCHEMA.items():
        if key not in record:
            errors.append(f"missing required key {key!r}")
        elif not isinstance(record[key], types):
            errors.append(
                f"key {key!r}: expected "
                f"{'/'.join(t.__name__ for t in types)}, got "
                f"{type(record[key]).__name__}")
    for key in sorted(set(record) - set(_SCHEMA)):
        errors.append(f"unknown key {key!r}")
    if isinstance(record.get("schema_version"), int) and (
            record["schema_version"] > MANIFEST_SCHEMA_VERSION
            or record["schema_version"] < 1):
        errors.append(
            f"schema_version {record['schema_version']} outside the "
            f"supported range [1, {MANIFEST_SCHEMA_VERSION}]")
    if "kind" in record and record.get("kind") not in _KINDS:
        errors.append(f"kind {record.get('kind')!r} not one of {_KINDS}")
    for k, v in (record.get("artifacts") or {}).items():
        if not isinstance(v, str):
            errors.append(f"artifacts[{k!r}]: digest must be a string")
    return errors


def default_manifest_path(root: Optional[Path] = None) -> Path:
    base = Path(root) if root is not None else Path.cwd()
    return base / "artifacts" / "manifests_torch" / "runs.jsonl"


def append_record(record: dict, path=None) -> Path:
    """Append one record to the JSONL manifest (creating it); returns
    the path written.  Raises on an invalid record -- provenance files
    must never accumulate garbage."""
    errs = validate_record(record)
    if errs:
        raise ValueError(f"invalid RunRecord: {'; '.join(errs)}")
    p = Path(path) if path is not None else default_manifest_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a") as fh:
        fh.write(json.dumps(record, sort_keys=True, default=float) + "\n")
    return p


def read_records(path) -> Iterable[dict]:
    for i, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{path}:{i + 1}: invalid JSONL ({exc})")
