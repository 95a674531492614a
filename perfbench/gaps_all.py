"""The gaps of every served token of one run, not only of the sample a run
checks: the program serves the cell's traffic at its own rate for the
mix's lead and ``--seconds``, then every finished request goes through the
reference, in groups of at most ``SAMPLE_TOKENS`` tokens, with the
router's margins. What a cell's limit and tie margin are read from where a
run's sample is too small to show the tail.

    python3 perfbench/gaps_all.py --workload <cell> --seed 7 \
        --seconds 48 --out gaps.npz

Prints, for each tie margin, the positions kept and the widest gaps among
them, then the widest gaps with their margins and places; ``--out`` keeps
every position's gap, least margin, request id and output index.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIES = (0.0, 0.03, 0.05, 0.06, 0.07, 0.08, 0.1, 0.12, 0.15)
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def groups(reqs, budget: int):
    """Consecutive runs of ``reqs`` whose prompt and output tokens fit in
    ``budget``."""
    out, cur, n = [], [], 0
    for r in reqs:
        k = r.prompt_len + len(r.out_tokens)
        if cur and n + k > budget:
            out.append(cur)
            cur, n = [], 0
        cur.append(r)
        n += k
    return out + ([cur] if cur else [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=48.0)
    ap.add_argument("--out", help="an .npz of every position")
    args = ap.parse_args(argv)

    import torch

    from perfbench import check, harness

    if not torch.cuda.is_available():
        print("the readings need a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_bench(ROOT), args.workload, args.seed,
                        "cuda")
    rate = float(cell.mix["rate"])
    classes, plan, gate = cell.plan(rate)
    engine = cell.engine()
    rec = cell.serve(engine, gate, len(classes), args.seed, args.seconds,
                     rate)
    del engine
    torch.cuda.empty_cache()
    done = sorted((r for r in rec.requests if r.done), key=lambda r: r.rid)
    g, m, rid, j = [], [], [], []
    for grp in groups(done, harness.SAMPLE_TOKENS):
        mg = []
        gg, _ = check.token_gaps(torch, cell.family, cell.cfg, cell.params,
                                 grp, "cuda", margins=mg)
        g.append(gg)
        m.append(np.min(np.stack(mg), axis=0) if mg
                 else np.full(gg.shape, np.inf))
        for r in grp:
            rid.append(np.full(len(r.out_tokens), r.rid))
            j.append(np.arange(len(r.out_tokens)))
    g, m = np.concatenate(g), np.concatenate(m)
    rid, j = np.concatenate(rid), np.concatenate(j)
    print(json.dumps({"requests": len(done), "positions": int(g.size)}))
    for tie in TIES:
        keep = m >= tie
        print(json.dumps({"tie": tie, "kept": int(keep.sum()),
                          "widest": np.sort(g[keep])[::-1][:5].tolist()}))
    for t in np.argsort(-np.where(m >= 0.05, g, -1))[:5]:
        print(json.dumps({"gap": float(g[t]), "margin": float(m[t]),
                          "rid": int(rid[t]), "out": int(j[t])}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.out, gap=g, margin=m, rid=rid, out=j)
    return 0


if __name__ == "__main__":
    sys.exit(main())
