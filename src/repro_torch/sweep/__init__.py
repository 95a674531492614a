"""Batched policy-sweep subsystem (the reference's ``repro.sweep``).

Evaluates a (workload mix x policy x cluster size x seed) grid in one
call -- the execution backbone of the paper's convergence (EC.8.5),
scaling (EC.8.3), heterogeneity and scenario studies.

* :mod:`repro_torch.sweep.spec` -- ``SweepSpec`` / ``SweepResult`` JSON
  schema (the reference's), per-cell ``SeedSequence`` streams, the
  :class:`Evaluator` protocol + registry (``get_evaluator`` /
  ``register_evaluator``).
* :mod:`repro_torch.sweep.evaluators` -- policy-token registry + the
  registered ctmc / ctmc_jax / fluid / lp / lp_jax / engine / engine_jax
  evaluators (the ``_jax`` names and ``fluid`` run on the card).
* :mod:`repro_torch.sweep.fluid_batch` -- the batched fluid-ODE grid.
* :mod:`repro_torch.sweep.sharded` -- cell placement over devices;
  :data:`PLACEMENTS` catalog.
* :mod:`repro_torch.sweep.runner` -- :func:`run_sweep` grid executor.
* :mod:`repro_torch.sweep.run` -- ``python -m repro_torch.sweep.run``.
"""

from .spec import (CellResult, Evaluator, MixSpec, SweepResult,
                   SweepSchemaError, SweepSpec, cell_seed_sequence,
                   get_evaluator, register_evaluator, validate_payload)
from .runner import run_sweep, spec_sha256
from .sharded import PLACEMENTS

__all__ = [
    "CellResult",
    "Evaluator",
    "MixSpec",
    "PLACEMENTS",
    "SweepResult",
    "SweepSchemaError",
    "SweepSpec",
    "cell_seed_sequence",
    "get_evaluator",
    "register_evaluator",
    "validate_payload",
    "run_sweep",
    "spec_sha256",
]
