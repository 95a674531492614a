"""The port's uniformized CTMC held to the JAX package on the
optimality-gap instance (``benchmarks/bench_optimality_gap.py``).

``OVERLOADED_MIX`` under ``ServicePrimitives()`` and ``Pricing()``, at the
artifact's smallest row: n=16, 32 seeds, horizon 300, warmup 75, float64
(the reference under ``enable_x64``, as the benchmark's
``extra={"ctmc_jax": {"x64": True}}``), for both pricing schemes --
separate charging judged against the separate plan.  The port draws from
Philox and the reference from threefry, so the two are held within 2 CI
half-widths of each other (the reference's own contract between its two
engines, ``tests/test_ctmc_jax.py``).  The port runs the kernel's plain
version here, which the card holds the kernel to bit for bit; so this is
also a witness for ``chip_smoke.py``'s n=16 rows against the artifact.
About 55 s on one CPU worker, most of it the plain version's 2 x ~26 k
steps.
"""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import ctmc_jax as ref_ctmc
from repro.core import planning as ref_planning
from repro.core import policies as ref_policies
from repro.core import types as ref_types
from repro_torch.core import ctmc_jax, planning, policies, types

# bench_optimality_gap.OVERLOADED_MIX: name, prompt, decode, lambda, patience
MIX = (("decode-heavy", 300, 1000, 1.0, 0.1),
       ("prefill-heavy", 3000, 400, 1.0, 0.1))
N, SEEDS, HORIZON, WARMUP = 16, 32, 300.0, 75.0  # its FULL_SCHEDULE[16]


def _gaps(ctmc_mod, plan_mod, pol_mod, types_mod, scheme, **kw):
    classes = [types_mod.WorkloadClass(nm, p, d, arrival_rate=lam,
                                       patience=th)
               for nm, p, d, lam, th in MIX]
    prim, price = types_mod.ServicePrimitives(), types_mod.Pricing()
    if scheme == "bundled":
        plan = plan_mod.solve_bundled_lp(classes, prim, price)
        pol = pol_mod.gate_and_route(plan)
    else:  # sweep/evaluators.py: the separate plan, charged separately
        plan = plan_mod.solve_separate_lp(classes, prim, price)
        pol = pol_mod.gate_and_route(
            plan, name="gate_and_route_separate").replace(charging="separate")
    sim = ctmc_mod.UniformizedCTMC(classes, prim, price, pol, n=N,
                                   horizon=HORIZON, warmup=WARMUP, **kw)
    res = sim.results_from_raw(sim.run_batch_raw(list(range(SEEDS))))
    assert all(r.t_end == HORIZON for r in res)  # budget_exhausted == 0
    return np.array([100.0 * (1.0 - r.revenue_rate_per_server
                              / plan.revenue_rate) for r in res])


def _half_width(v):
    return 1.96 * np.std(v, ddof=1) / np.sqrt(len(v))


@pytest.mark.parametrize("scheme", ["bundled", "separate"])
def test_gap_at_n16_matches_the_reference(scheme):
    """The port's gap (the plain version, float64) and the reference's
    ``ctmc_jax`` under x64 agree within 2 CI half-widths."""
    with enable_x64():
        ref = _gaps(ref_ctmc, ref_planning, ref_policies, ref_types, scheme)
    got = _gaps(ctmc_jax, planning, policies, types, scheme,
                dtype=torch.float64, device="cpu")
    hw = _half_width(got) + _half_width(ref)
    print(f"{scheme} n={N}: port {got.mean()!r}% (hw {_half_width(got)!r}),"
          f" reference {ref.mean()!r}% (hw {_half_width(ref)!r}), "
          f"difference {got.mean() - ref.mean()!r} vs 2 x {hw!r}")
    assert abs(got.mean() - ref.mean()) <= 2.0 * hw
