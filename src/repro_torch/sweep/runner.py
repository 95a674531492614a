"""Grid executor: run a :class:`SweepSpec`, get a :class:`SweepResult`.

One call evaluates the full (mix x policy x n x seed) cross product with
per-cell :class:`numpy.random.SeedSequence` streams (bitwise
reproducible, iteration-order independent).  Dispatch is uniform: every
evaluator sits behind the :class:`~repro_torch.sweep.spec.Evaluator`
protocol (``get_evaluator(spec.evaluator)``), deterministic ones
replicate a single solve over the degenerate seed axis, and grid-batched
ones (fluid ODE, batched planning LP) run their whole (mix x policy)
plane in ONE batched solve via their ``prepare`` hook before the cell
loop.

``spec.extra["placement"]`` selects the batch execution strategy for the
batched engines (one of :data:`repro_torch.sweep.sharded.PLACEMENTS`);
with ``"shard_map"`` the seed axis is split over the devices and the
result meta records their count.  ``device`` (the card unless ``"cpu"``
is passed) is where the batched evaluators run; it is not part of the
spec, so ``spec_sha256`` is the reference's for the same grid.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Callable, Optional

from repro_torch.compat import resolve_device
from repro_torch.telemetry.manifest import run_record

from .evaluators import MixContext, prewarm_plans
from .spec import SweepResult, SweepSpec, cell_seed_sequence, get_evaluator

__all__ = ["run_sweep", "spec_sha256"]


def spec_sha256(spec: SweepSpec) -> str:
    """The spec's digest, as the reference's runner records it."""
    return hashlib.sha256(
        json.dumps(spec.to_dict(), sort_keys=True,
                   default=float).encode()).hexdigest()


def run_sweep(spec: SweepSpec,
              progress: Optional[Callable[[str], None]] = None, *,
              device=None) -> SweepResult:
    """Evaluate every cell of ``spec``'s grid on ``device`` and collect
    the results."""
    t0 = time.time()
    say = progress or (lambda _msg: None)
    dev = resolve_device(device)
    placement = spec.extra.get("placement")
    if placement is not None:
        from .sharded import PLACEMENTS

        if placement not in PLACEMENTS:
            raise ValueError(
                f"extra['placement'] must be one of {PLACEMENTS}, "
                f"got {placement!r}")
    contexts = [MixContext(mix, spec, device=dev) for mix in spec.mixes]
    ev = get_evaluator(spec.evaluator)
    cells: list = []

    if ev.prepare is not None:
        # grid-batched evaluators: one batched solve for the whole
        # (mix x policy) plane, parked on the contexts' caches
        say(f"[{spec.name}] {ev.name}: batch-preparing "
            f"{len(contexts) * len(spec.policies)} instances")
        ev.prepare(contexts, spec.policies, spec.extra)
    elif spec.extra.get("batch_plans"):
        # one batched interior-point run replaces the per-mix serial
        # simplex solves the cell evaluators would otherwise trigger
        solved = prewarm_plans(contexts, spec.policies)
        say(f"[{spec.name}] prewarmed {solved} planning LPs (batch_plans)")

    # extra["crn_policies"]: common random numbers across the policy
    # axis -- every policy sees the same per-(mix, n, seed) streams,
    # turning policy comparisons into paired comparisons (the EC.8.6
    # ablation protocol; variance reduction for rankings).
    crn = bool(spec.extra.get("crn_policies", False))
    for mi, ctx in enumerate(contexts):
        for pi, token in enumerate(spec.policies):
            for ni, n in enumerate(spec.n_servers):
                streams = [cell_seed_sequence(spec, mi, 0 if crn else pi,
                                              ni, si)
                           for si in range(spec.n_seeds)]
                say(f"[{spec.name}] {ctx.mix.name} / {token} / n={n} "
                    f"({spec.n_seeds} seeds)")
                cells.extend(ev(ctx, token, n, seeds=streams))

    meta = {
        "evaluator": spec.evaluator,
        "n_cells": len(cells),
        "wall_seconds": round(time.time() - t0, 3),
    }
    if placement is not None:
        meta["placement"] = placement
        if placement == "shard_map":
            shard = spec.extra.get("shard") or {}
            if "devices" in shard:
                meta["shard_devices"] = len(shard["devices"])
            else:
                from .sharded import detected_devices

                meta["shard_devices"] = int(
                    shard.get("n_devices") or detected_devices())
    # schema-versioned provenance record (RunRecord); riders like the
    # sweep CLI append it to artifacts/manifests_torch/runs.jsonl
    meta["manifest"] = run_record(
        kind="sweep", name=spec.name,
        wall_s=meta["wall_seconds"], device=dev,
        extra={"evaluator": spec.evaluator, "n_cells": len(cells),
               "placement": placement, "spec_sha256": spec_sha256(spec)})
    return SweepResult(spec=spec, cells=cells, meta=meta)
