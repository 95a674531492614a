"""The readings a cell's ``logit_gap`` limit is set from, on the card, in
one process: for each seed, the program serves the cell's traffic at its
own rate and size for the mix's lead and ``--seconds``, and on the sample
a run checks, the reference reads the program's widest gap and the
control's (the reference computed in fp8, put in the program's place).

    python3 perfbench/limits.py --workload <cell> --seconds 10 \
        --seeds 11,12,13 [--control-seeds 11,12,13]

Prints one JSON line per seed; the limit lies above the largest program
reading and below the smallest control reading (see PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIES = (0.02, 0.05, 0.1)
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _stats(g, margin) -> dict:
    """The widest gap, and the widest over positions clear of a routing
    tie by each of a few margins."""
    out = {"widest": float(g.max()), "p99": float(np.percentile(g, 99))}
    for tie in TIES:
        keep = margin >= tie
        out[f"widest_untied_{tie}"] = float(g[keep].max())
        out[f"share_tied_{tie}"] = float(1 - keep.mean())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", help="an .npz of every seed's per-token gaps")
    args = ap.parse_args(argv)
    arrays = {}

    import torch

    from perfbench import check, harness
    from perfbench.reference import gate as ref_gate

    if not torch.cuda.is_available():
        print("the readings need a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = harness.Cell(bench, args.workload, seed, "cuda")
        rate = float(cell.mix["rate"])
        classes, plan, gate = cell.plan(rate)
        engine = cell.engine()
        rec = cell.serve(engine, gate, len(classes), seed, args.seconds,
                            rate)
        del engine
        torch.cuda.empty_cache()
        picked = check.sample(rec.requests, seed,
                              max_tokens=harness.SAMPLE_TOKENS,
                              min_served=harness.SAMPLE_SERVED)
        x, qp, _ = ref_gate.solve_plan(
            [(c.prompt_len, c.decode_len, c.arrival_rate, c.patience)
             for c in classes], dict(cell.pr, batch_cap=cell.sv["batch_cap"],
                                     chunk=cell.sv["chunk"]), cell.pricing.c_p,
            cell.pricing.c_d)
        margins = []
        g, c = check.token_gaps(torch, cell.family, cell.cfg, cell.params,
                                picked, "cuda", margins=margins,
                                control=seed in ctrl_seeds)
        m = np.min(np.stack(margins), axis=0)
        row = {"seed": seed, "requests": len(picked),
               "served_tokens": int(g.size),
               "gate_mismatches": ref_gate.check_admissions(
                   rec.admissions, x, qp),
               # the reference's router margin at the widest gap: near 0,
               # a tie that rounding decides
               "margin_at_widest": float(m[int(g.argmax())]),
               "program": _stats(g, m)}
        if c is not None:
            row["control"] = _stats(c, m)
        if args.out:
            arrays[str(seed)] = np.stack([g, m] + ([c] if c is not None
                                                   else []))
        row["s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del cell
        torch.cuda.empty_cache()
    if args.out:
        np.savez_compressed(args.out, **arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
