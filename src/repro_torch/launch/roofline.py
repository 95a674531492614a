"""Roofline analysis over the dry-run artifacts.

Per (arch x shape x mesh x strategy) cell, from the dry-run record:

    compute term    = FLOPs_per_device / peak_FLOP/s              [s]
    memory term     = bytes_per_device / HBM_bw                   [s]
    collective term = collective_bytes_per_device / link_bw       [s]

(the port's records keep each count globally and per device; the terms
read the per-device figures, ``extrapolated.flops`` and ``.bytes``;
collective bytes come from the HLO-form parse with ring factors.)  The
dominant term is the bottleneck; the reported

    roofline_fraction = T_ideal / T_bound,
    T_ideal = max(MODEL_FLOPS/chips/peak, argument_bytes/HBM_bw)
    T_bound = max(compute, memory, collective terms)

is the score the perf loop climbs: T_ideal is the physics floor (useful
FLOPs at peak, or the resident state streamed exactly once -- whichever
binds), T_bound is what the traced program would take at roofline speeds.

The hardware is the reference's TPU v5e table by default, so a reference
record gives the reference's terms bit for bit; ``--hw h100`` evaluates
against the H100 SXM's data-sheet table (:func:`hw_constants`).

Usage: python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch]
           [--hw v5e|h100] [--md out.md]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.mesh import gpu_table, v5e_constants

__all__ = ["roofline_terms", "load_records", "render_table", "hw_constants"]

#: ``--hw`` choice -> card name in :data:`repro_torch.launch.mesh.GPU_TABLES`
_CARDS = {"h100": "NVIDIA H100 80GB HBM3"}


def hw_constants(name: str = "v5e") -> dict:
    """The roofline's hardware table: ``"v5e"`` (the reference's) or a card
    of ``_CARDS``, whose NVLink link rate stands in the interconnect term."""
    if name == "v5e":
        return v5e_constants()
    c = gpu_table(_CARDS[name])[1]
    return {"peak_flops_bf16": c["peak_flops_bf16"], "hbm_bw": c["hbm_bw"],
            "ici_link_bw": c["link_bw"]}


def roofline_terms(rec: dict, hw: dict | None = None) -> dict:
    hw = hw or v5e_constants()
    ex = rec["extrapolated"]
    chips = rec["n_devices"]
    t_c = ex["flops"] / hw["peak_flops_bf16"]
    t_m = ex["bytes"] / hw["hbm_bw"]
    t_x = ex["coll_total"] / hw["ici_link_bw"]
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    t_ideal_c = rec["model_flops"] / chips / hw["peak_flops_bf16"]
    t_ideal_m = rec["memory"]["argument_bytes"] / hw["hbm_bw"]
    t_ideal = max(t_ideal_c, t_ideal_m)
    t_bound = max(t_c, t_m, t_x)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "model_flops": rec["model_flops"],
        "hlo_flops_per_dev": ex["flops"],
        "useful_flop_ratio": (rec["model_flops"] / chips / ex["flops"]
                              if ex["flops"] else float("nan")),
        "t_ideal_s": t_ideal,
        "t_bound_s": t_bound,
        "roofline_fraction": t_ideal / t_bound if t_bound else float("nan"),
        "arg_gib_per_dev": rec["memory"]["argument_bytes"] / 2**30,
    }


def load_records(d: Path, mesh: str = "pod16x16",
                 strategy: str | None = None) -> list[dict]:
    out = []
    for p in sorted(d.glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("mesh") != mesh:
            continue
        if strategy is not None and rec.get("strategy") != strategy:
            continue
        out.append(rec)
    return out


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def render_table(recs: list[dict], hw: dict | None = None) -> str:
    hdr = ("| arch | shape | strat | compute | memory | collective | "
           "dominant | useful-FLOP | arg GiB/dev | roofline frac | note |")
    sep = "|" + "---|" * 11
    rows = [hdr, sep]
    for r in recs:
        if "skipped" in r:
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['strategy']} | -- | -- |"
                f" -- | -- | -- | -- | -- | SKIP: {r['skipped']} |")
            continue
        if not r.get("ok"):
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['strategy']} | -- | -- |"
                f" -- | -- | -- | -- | -- | FAIL |")
            continue
        t = roofline_terms(r, hw)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['strategy']} |"
            f" {_fmt_s(t['compute_s'])} | {_fmt_s(t['memory_s'])} |"
            f" {_fmt_s(t['collective_s'])} | {t['dominant']} |"
            f" {t['useful_flop_ratio']:.3f} | {t['arg_gib_per_dev']:.2f} |"
            f" {t['roofline_fraction']:.3f} | |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(
        Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"))
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--hw", default="v5e", choices=["v5e", *sorted(_CARDS)])
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    recs = load_records(Path(args.dir), args.mesh, args.strategy)
    table = render_table(recs, hw_constants(args.hw))
    print(table)
    if args.md:
        Path(args.md).write_text(table + "\n")


if __name__ == "__main__":
    main()
