"""CLI entry for batched policy sweeps.

    PYTHONPATH=src python -m repro_torch.sweep.run \
        --policies gate_and_route,sli_aware,FG-SP \
        --ns 20,50,100 --n-seeds 8 --out artifacts/sweep_torch/default.json

Runs the (policy x cluster-size x seed x mix) grid through the chosen
evaluator and writes one schema-validated JSON artifact (see
:mod:`repro_torch.sweep.spec`).  ``--spec FILE`` replays a previously
saved spec verbatim.  ``--device`` says where the batched evaluators
run: the card by default (the run fails without one), ``cpu`` on the
host.  The artifact's run record goes to
``artifacts/manifests_torch/runs.jsonl`` when the artifact lies under
``artifacts/``, else to a ``.runs.jsonl`` file beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from repro_torch.telemetry.manifest import append_record, file_digest

from .runner import run_sweep
from .sharded import PLACEMENTS
from .spec import EVALUATORS, MixSpec, SweepResult, SweepSpec

__all__ = ["main", "default_mix", "fmt_table"]

# The EC.8.5 two-class synthetic instance (decode-heavy vs prefill-heavy);
# the same instance anchors bench_sli_pareto / bench_convergence.
TWO_CLASS = MixSpec(
    name="two_class",
    classes=(
        dict(name="decode-heavy", prompt_len=300, decode_len=1000,
             arrival_rate=0.5, patience=0.1),
        dict(name="prefill-heavy", prompt_len=3000, decode_len=400,
             arrival_rate=0.5, patience=0.1),
    ),
)

MIX_PRESETS = {"two_class": TWO_CLASS}


def default_mix(name: str = "two_class") -> MixSpec:
    return MIX_PRESETS[name]


def _csv(s: str) -> tuple:
    return tuple(p for p in s.split(",") if p)


def fmt_table(rows, cols, title):
    w = {c: max(len(c), *(len(f"{r.get(c, '')}") for r in rows)) for c in cols}
    out = [title, " | ".join(c.ljust(w[c]) for c in cols)]
    out.append("-|-".join("-" * w[c] for c in cols))
    for r in rows:
        out.append(" | ".join(f"{r.get(c, '')}".ljust(w[c]) for c in cols))
    return "\n".join(out)


def build_spec(args) -> SweepSpec:
    if args.spec:
        d = json.loads(Path(args.spec).read_text())
        if "spec" in d and "schema_version" in d:
            d = d["spec"]  # a saved SweepResult artifact: replay its grid
        return SweepSpec.from_dict(d)
    if args.smoke:
        return SweepSpec(
            name=args.name or "smoke", evaluator="ctmc",
            policies=("gate_and_route",), n_servers=(20,), n_seeds=1,
            seed=args.seed, mixes=(default_mix(args.mix or "two_class"),),
            horizon=5.0, warmup=1.0)
    policies = _csv(args.policies)
    ns = tuple(int(n) for n in _csv(args.ns))
    n_seeds = args.n_seeds
    horizon, warmup = args.horizon, args.warmup
    if args.quick:
        ns = ns[:2]
        n_seeds = min(n_seeds, 2)
        horizon, warmup = min(horizon, 40.0), min(warmup, 10.0)
    mixes = (default_mix(args.mix or "two_class"),)
    if args.scenarios:
        # scenario axis: one mix per registered workload scenario; only
        # the trace-driven evaluators generate from scenarios
        if args.mix is not None:
            raise SystemExit("--scenarios and --mix are mutually exclusive "
                             "(each scenario becomes its own mix)")
        if args.evaluator not in ("engine", "engine_jax"):
            raise SystemExit(
                "--scenarios needs a trace-driven evaluator "
                "(--evaluator engine or engine_jax)")
        from repro_torch.workloads import get_scenario

        names = _csv(args.scenarios)
        overrides = {}
        if args.rate_scale != 1.0:
            overrides["rate_scale"] = args.rate_scale
        mixes = tuple(
            MixSpec(
                name=name, scenario=name,
                # only spec.horizon is replayed: don't generate (and, for
                # engine_jax, tensorize) arrivals past it
                trace=dict(
                    overrides,
                    horizon=min(horizon, get_scenario(name).horizon)))
            for name in names)
    extra = dict(json.loads(args.extra)) if args.extra else {}
    if args.placement:
        extra["placement"] = args.placement
    return SweepSpec(
        name=args.name or "sweep", evaluator=args.evaluator,
        policies=policies, n_servers=ns, n_seeds=n_seeds, seed=args.seed,
        mixes=mixes, horizon=horizon, warmup=warmup, extra=extra)


def summarize(result: SweepResult) -> str:
    spec = result.spec
    rows = []
    key = ("revenue" if spec.evaluator in ("lp", "lp_jax")
           else "revenue_rate")
    for mix in spec.mixes:
        for token in spec.policies:
            for n in spec.n_servers:
                sel = result.select(mix=mix.name, policy=token, n=n)
                if not sel:
                    continue
                vals = np.array([c.metrics[key] for c in sel])
                row = {"mix": mix.name, "policy": token, "n": n,
                       key: round(float(vals.mean()), 2),
                       "std": round(float(vals.std()), 2),
                       "seeds": len(sel)}
                gaps = [c.metrics["gap_pct"] for c in sel
                        if "gap_pct" in c.metrics]
                if gaps:
                    row["gap_pct"] = round(float(np.mean(gaps)), 2)
                rows.append(row)
    cols = ["mix", "policy", "n", key, "std", "seeds"]
    if any("gap_pct" in r for r in rows):
        cols.append("gap_pct")
    return fmt_table(rows, cols,
                      f"\n[sweep:{spec.name}] {spec.evaluator} grid, "
                      f"{result.meta.get('n_cells', len(result.cells))} cells "
                      f"in {result.meta.get('wall_seconds', '?')}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep.run",
        description="Run a batched (policy x n x seed x mix) sweep and "
                    "write one schema-validated JSON artifact.")
    ap.add_argument("--policies", default="gate_and_route,sli_aware,FG-SP",
                    help="comma-separated policy tokens")
    ap.add_argument("--ns", default="20,50,100",
                    help="comma-separated cluster sizes")
    ap.add_argument("--n-seeds", type=int, default=8,
                    help="seed replications per cell")
    ap.add_argument("--seed", type=int, default=0,
                    help="master entropy for the per-cell streams")
    ap.add_argument("--evaluator", default="ctmc", choices=EVALUATORS)
    ap.add_argument("--placement", default=None, choices=PLACEMENTS,
                    help="batch execution strategy for the batched "
                         "evaluators (shard_map splits the seed axis over "
                         "the visible CUDA cards; default vmap)")
    ap.add_argument("--device", default=None,
                    help="where the batched evaluators run (default: the "
                         "CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--mix", default=None, choices=sorted(MIX_PRESETS),
                    help="workload-mix preset (default two_class; "
                         "mutually exclusive with --scenarios)")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated workload-scenario names (the "
                         "scenario axis: one mix per name; engine/"
                         "engine_jax evaluators only; see python -m "
                         "repro_torch.workloads.run --list)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="scenario arrival-intensity multiplier "
                         "(with --scenarios)")
    ap.add_argument("--horizon", type=float, default=90.0)
    ap.add_argument("--warmup", type=float, default=30.0)
    ap.add_argument("--extra", default=None,
                    help="JSON object merged into the spec's extra, e.g. "
                         "'{\"engine_jax\": {\"fastforward\": true}}'")
    ap.add_argument("--name", default=None, help="sweep/artifact name")
    ap.add_argument("--spec", default=None,
                    help="JSON file with a full SweepSpec (overrides flags)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default "
                         "artifacts/sweep_torch/<name>.json)")
    ap.add_argument("--quick", action="store_true",
                    help="trim the grid for a fast sanity run")
    ap.add_argument("--smoke", action="store_true",
                    help="minimal 1x1x1 grid (CI smoke test)")
    args = ap.parse_args(argv)

    spec = build_spec(args)
    print(f"[sweep:{spec.name}] {spec.evaluator}: "
          f"{len(spec.policies)} policies x {len(spec.n_servers)} sizes x "
          f"{spec.n_seeds} seeds x {len(spec.mixes)} mixes "
          f"= {spec.n_cells} cells", flush=True)
    result = run_sweep(spec, progress=lambda m: print(m, flush=True),
                       device=args.device)
    print(summarize(result))
    out = Path(args.out) if args.out else (
        Path("artifacts") / "sweep_torch" / f"{spec.name}.json")
    result.save(out)
    print(f"[sweep:{spec.name}] wrote {out}")
    record = result.meta.get("manifest")
    if record is not None:
        record = dict(record, artifacts={str(out): file_digest(out)})
        # the repo-central log is for artifacts that live in the repo's
        # artifacts/ tree; a sweep written elsewhere (smoke runs, /tmp)
        # carries its manifest next to the artifact instead
        central = Path("artifacts").resolve()
        in_repo = out.resolve().is_relative_to(central)
        mpath = append_record(record) if in_repo else append_record(
            record, out.with_name(out.stem + ".runs.jsonl"))
        print(f"[sweep:{spec.name}] manifest -> {mpath}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
