"""Perf hillclimb loop: run strategies on a cell, diff roofline terms.

    python -m repro_torch.launch.perf_loop --arch deepseek-v3-671b \\
        --shape decode_32k --strategies baseline,kv_int8,kv_heads

Each strategy traces the cell on the meta device (no devices needed;
:mod:`repro_torch.launch.dryrun`), the roofline terms are tabulated
against the baseline, and the deltas on the dominant term are printed --
the measurement half of the hypothesis -> change -> measure -> validate
loop.  ``--hw h100`` evaluates against the H100 SXM's table instead of
the reference's TPU v5e table; ``--out`` takes the records' directory.
"""

import argparse
from pathlib import Path

from repro_torch.launch.dryrun import ARTIFACTS, STRATEGIES, run_cell
from repro_torch.launch.roofline import hw_constants, roofline_terms


def fmt(x):
    if x >= 1:
        return f"{x:8.3f}s "
    if x >= 1e-3:
        return f"{x*1e3:8.3f}ms"
    return f"{x*1e6:8.1f}us"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--strategies", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--hw", default="v5e", choices=["v5e", "h100"])
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    hw = hw_constants(args.hw)
    base_terms = None
    print(f"perf loop: {args.arch} x {args.shape}")
    hdr = (f"{'strategy':14s} {'compute':10s} {'memory':10s} {'collect':10s}"
           f" {'dominant':10s} {'roofline%':9s} {'d(dom)%':8s}")
    print(hdr)
    for s in args.strategies.split(","):
        assert s in STRATEGIES, (s, sorted(STRATEGIES))
        rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       strategy_name=s, out_dir=Path(args.out))
        if not rec.get("ok"):
            print(f"{s:14s} FAIL {rec.get('error', rec.get('skipped'))}")
            continue
        t = roofline_terms(rec, hw)
        if base_terms is None:
            base_terms = t
            delta = ""
        else:
            dom = base_terms["dominant"] + "_s"
            delta = f"{100 * (t[dom] / base_terms[dom] - 1):+7.1f}%"
        print(f"{s:14s} {fmt(t['compute_s'])} {fmt(t['memory_s'])} "
              f"{fmt(t['collective_s'])} {t['dominant']:10s} "
              f"{100 * t['roofline_fraction']:8.2f}% {delta}")


if __name__ == "__main__":
    main()
