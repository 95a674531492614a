"""Nonstationary workload scenarios (the reference's ``repro.workloads``).

Layers:

* :mod:`repro_torch.workloads.arrivals` -- arrival processes (Poisson,
  k-regime MMPP, piecewise-constant rate-shift / flash-crowd / diurnal).
* :mod:`repro_torch.workloads.scenarios` -- the declarative
  :class:`Scenario` spec, capacity-event scripts, and the registry of
  built-ins (:func:`get_scenario` / :func:`list_scenarios`).
* :mod:`repro_torch.workloads.batch` -- batched (seeds x scenarios) trace
  generation on the device and the chunked :class:`ScenarioStream`
  (import it from its module).

The closed-loop control harness (``closed_loop``: ``ClosedLoopConfig``,
``VARIANTS``, ``run_closed_loop``, ``compare_policies``,
``plans_for_scenarios``) and the ``run`` CLI come with the sweep and
control layers (ROADMAP A8).
"""

from .arrivals import (ArrivalProcess, MMPPArrivals,
                       PiecewiseConstantArrivals, PoissonArrivals, diurnal,
                       flash_crowd, rate_shift)
from .scenarios import (CapacityEvent, EVENT_KINDS, Scenario, ScenarioError,
                        get_scenario, list_scenarios, register_scenario)

__all__ = [
    "ArrivalProcess",
    "PoissonArrivals",
    "MMPPArrivals",
    "PiecewiseConstantArrivals",
    "rate_shift",
    "flash_crowd",
    "diurnal",
    "CapacityEvent",
    "EVENT_KINDS",
    "Scenario",
    "ScenarioError",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
]
