"""End-to-end calibration entry point + CLI.

``calibrate()`` runs the full pipeline -- grid -> timing backend -> robust
fit -> artifact -- for one architecture from the :mod:`repro_torch.configs`
registry.  The CLI writes the artifact JSON and prints a one-line summary
with the fitted paper constants and fit diagnostics:

    python -m repro_torch.calibration --arch qwen2-0.5b --backend kernels \
        --out artifacts/calibration/qwen2-0.5b.json

The kernels backend runs on the CUDA card unless ``--device cpu`` is
given (the kernels' plain versions under a host clock: a test of the
control flow, never a device figure).
"""

from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.compat import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import hw_record, v5e_constants

from .artifact import CalibrationArtifact
from .fit import fit_surfaces
from .grid import CalibrationGrid
from .measure import collect_samples, resolve_backend

__all__ = ["calibrate"]


def calibrate(arch: str = "qwen2-0.5b", *,
              grid: Optional[CalibrationGrid] = None,
              backend: str = "auto", reps: int = 5, reduced: bool = False,
              created: str = "", device=None) -> CalibrationArtifact:
    """Time + fit one architecture; returns the artifact (not saved).

    The kernels backend runs on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``); the roofline backend
    touches no device.
    """
    grid = grid or CalibrationGrid.default()
    cfg = get_config(arch, reduced=reduced)
    backend = resolve_backend(backend)
    if backend == "kernels":
        dev = resolve_device(device)
        hw = hw_record(dev)
    else:
        dev, hw = None, v5e_constants()
    samples = collect_samples(grid, cfg, backend=backend, reps=reps,
                              device=dev, hw=hw)
    fits = fit_surfaces(samples)
    return CalibrationArtifact(
        arch=arch,
        backend=samples[0].backend,
        grid=grid,
        samples=tuple(samples),
        mix=fits["mix"],
        solo=fits["solo"],
        hw={k: v if isinstance(v, str) else float(v) for k, v in hw.items()},
        created=created,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "kernels", "roofline"])
    ap.add_argument("--tiny", action="store_true",
                    help="CI-smoke grid instead of the default grid")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-smoke) model config")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="kernels backend device (default cuda; 'cpu' runs "
                         "the plain versions)")
    ap.add_argument("--out", default=None, help="artifact JSON path")
    args = ap.parse_args(argv)

    grid = CalibrationGrid.tiny() if args.tiny else CalibrationGrid.default()
    art = calibrate(args.arch, grid=grid, backend=args.backend,
                    reps=args.reps, reduced=args.reduced, device=args.device)
    print(f"[calibrate] {art.arch} backend={art.backend} "
          f"alpha={art.alpha:.6g} beta={art.beta:.6g} "
          f"a_s={art.a_s:.6g} b_s={art.b_s:.6g} "
          f"r2(mix)={art.mix.r2:.4f} r2(solo)={art.solo.r2:.4f}")
    if args.out:
        path = art.save(args.out)
        print(f"[calibrate] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
