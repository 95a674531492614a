"""Parse collective traffic out of HLO-form text.

The reference's ``launch/hlo_analysis``, with the same regexes, ring
factors and output.  The reference regexes a compiled SPMD module; the
port runs no SPMD program, so its dry run (:mod:`.dryrun`) writes one
HLO-form line per collective that the layout makes necessary, e.g.

    %c = bf16[4096,896] all-gather(%p), replica_groups=[16,16]<=[256]

and this parser reads those lines, so the ring factors live in one
place.  Each op's largest shape token is its per-device payload, which
converts to per-device interconnect traffic with the standard ring-
algorithm factors:

    all-reduce       2 (k-1)/k * N
    all-gather       (k-1)/k * N      (N = gathered result)
    reduce-scatter   (k-1)/k * N      (N = scattered operand)
    all-to-all       (k-1)/k * N
    collective-permute           N

Either text gives the same numbers for the same lines: the port's parse of
the reference's compiled modules is held bitwise to the reference's.
"""

from __future__ import annotations

import re

__all__ = ["collective_traffic", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "f64": 8, "u64": 8, "s64": 8, "c64": 8,
    "f32": 4, "u32": 4, "s32": 4,
    "bf16": 2, "f16": 2, "u16": 2, "s16": 2,
    "u8": 1, "s8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e5m2fnuz": 1,
    "u4": 0.5, "s4": 0.5,
}

_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[\d+\]")
_LIST_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
# matches only a *flat* (possibly empty) pair list -- "{}" or "{0,1}";
# nested "{{0,1},...}" deliberately fails to match (real traffic).
_PERMUTE_PAIRS_RE = re.compile(r"source_target_pairs=\{([^{}]*)\}")


def _shape_bytes(dtype: str, dims: str) -> float:
    if dtype not in DTYPE_BYTES:
        return 0.0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES[dtype]


def _group_size(line: str) -> int:
    m = _IOTA_GROUPS_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    m = _LIST_GROUPS_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    return 1


def collective_traffic(hlo_text: str) -> dict:
    """Per-device collective traffic (bytes) by op kind + total + op count."""
    out = {k: 0.0 for k in _OPS}
    counts = {k: 0 for k in _OPS}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        kind = None
        for op in _OPS:
            # match the op as instruction (e.g. " = bf16[...] all-gather(")
            if f" {op}(" in stripped or f" {op}-start(" in stripped:
                kind = op
                break
        if kind is None:
            continue
        shapes = _SHAPE_RE.findall(stripped.split("metadata=")[0])
        if not shapes:
            continue
        payload = max(_shape_bytes(dt, dims) for dt, dims in shapes)
        k = _group_size(stripped)
        if kind == "all-reduce":
            traffic = 2.0 * (k - 1) / k * payload if k > 1 else 0.0
        elif kind == "collective-permute":
            pairs = _PERMUTE_PAIRS_RE.search(stripped)
            empty = pairs is not None and not pairs.group(1).strip()
            traffic = 0.0 if empty else payload
        else:
            traffic = (k - 1) / k * payload if k > 1 else 0.0
        out[kind] += traffic
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _OPS)
    out["counts"] = counts
    return out
