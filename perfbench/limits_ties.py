"""``limits.py``'s readings at more tie margins, and how many positions
each keeps: a router as wide as DeepSeek-V3's leaves few positions clear
of a tie at ``limits.py``'s own margins, and none at some, where that
script raises. Here a margin that keeps nothing reads None.

    python3 perfbench/limits_ties.py --workload <cell> --seconds 48 \
        --seeds 11,12,13 [--control-seeds 11,12,13] [--out gaps.npz]

Arguments and output lines as ``limits.py``'s; each reading adds
``positions`` (every served token compared) and ``kept_<margin>``.
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIES = (0.0, 0.02, 0.05, 0.1, 0.2, 0.3)


def stats(g, margin, ties=TIES) -> dict:
    """The widest gap over all positions and over those clear of a
    routing tie by each margin, with the share tied and the count kept."""
    out = {"widest": float(g.max()), "p99": float(np.percentile(g, 99)),
           "positions": int(g.size)}
    for tie in ties:
        keep = margin >= tie
        out[f"widest_untied_{tie}"] = float(g[keep].max()) \
            if keep.any() else None
        out[f"share_tied_{tie}"] = float(1 - keep.mean())
        out[f"kept_{tie}"] = int(keep.sum())
    return out


def main(argv=None) -> int:
    from perfbench import limits

    limits.TIES, limits._stats = TIES, stats
    return limits.main(argv)


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
