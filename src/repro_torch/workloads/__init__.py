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
* :mod:`repro_torch.workloads.closed_loop` -- OnlineController wired
  into the engine replay, compared against static/heuristic baselines.

CLI: ``python -m repro_torch.workloads.run`` (catalog listing,
generation stats, closed-loop comparisons).
"""

from .arrivals import (ArrivalProcess, MMPPArrivals,
                       PiecewiseConstantArrivals, PoissonArrivals, diurnal,
                       flash_crowd, rate_shift)
from .closed_loop import (VARIANTS, ClosedLoopConfig, compare_policies,
                          plans_for_scenarios, run_closed_loop)
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
    "ClosedLoopConfig",
    "VARIANTS",
    "run_closed_loop",
    "compare_policies",
    "plans_for_scenarios",
]
