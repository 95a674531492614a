"""Kernel-calibrated iteration-time models (the paper's Section 6.2 loop).

The engines consume the state-dependent service-rate surface

    tau_mix(C) = alpha + beta * C     (mixed iteration, prefill chunk C)
    tau_solo(K) = a_s + b_s * K       (decode-only iteration, resident KV K)

This package closes the silicon -> queueing-model -> policy loop: it
*measures* those surfaces from the port's own compute substrate -- the
CUDA kernels under :mod:`repro_torch.kernels` on the card, or the
deterministic analytic roofline (the reference's closed form against
``repro_torch.launch.mesh.v5e_constants``) when none is attached -- robust-fits
the affine models with residual/R^2 diagnostics, and emits a versioned
JSON :class:`CalibrationArtifact`.  The result plugs back into every
engine through the :class:`IterationTimeModel` protocol
(``MODELS`` registry: ``affine`` | ``fitted`` | ``table``).

``docs/CALIBRATION.md`` describes the grid design, fit method, model
plug points, artifact schema and fallback semantics of the reference,
which this package keeps.
"""

from .artifact import SCHEMA_VERSION, CalibrationArtifact
from .fit import AffineFit, FitDegenerateError, fit_affine, fit_surfaces
from .grid import CalibrationGrid
from .measure import (Sample, collect_samples, iteration_costs, roofline_tau,
                      timeit_median)
from .models import (DEFAULT_SOLO_KV_SLOPE, MODELS, AffineModel,
                     IterationTimeModel, TableModel, engine_config_for_model,
                     list_models, model_from_artifact)
from .run import calibrate

__all__ = [
    "SCHEMA_VERSION",
    "CalibrationArtifact",
    "AffineFit",
    "FitDegenerateError",
    "fit_affine",
    "fit_surfaces",
    "CalibrationGrid",
    "Sample",
    "collect_samples",
    "iteration_costs",
    "roofline_tau",
    "timeit_median",
    "DEFAULT_SOLO_KV_SLOPE",
    "MODELS",
    "AffineModel",
    "IterationTimeModel",
    "TableModel",
    "engine_config_for_model",
    "list_models",
    "model_from_artifact",
    "calibrate",
]
