"""The port's workload scenarios against ``repro.workloads``: arrival
processes, all registry scenarios' ``generate`` and ``tensorize``, and the
registry's errors.  Both are numpy on the same ``np.random.Generator``
seeds, so everything is held bitwise (tolerance 0)."""

import jax  # noqa: F401  (JAX and PyTorch share the process)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.workloads as rw
import repro_torch.workloads as tw

NAMES = rw.list_scenarios()


def _processes(w):
    return {
        "poisson": w.PoissonArrivals(rate=3.5),
        "mmpp2": w.MMPPArrivals(base_rate=2.0),
        "mmpp3": w.MMPPArrivals(base_rate=1.5, levels=(1.0, 4.0, 0.5),
                                switch=(0.2, 0.5, 0.1)),
        "piecewise": w.PiecewiseConstantArrivals(times=(0.0, 7.0, 20.0),
                                                 rates=(1.0, 5.0, 2.0)),
        "rate_shift": w.rate_shift(2.0, 6.0, t_shift=15.0),
        "flash_crowd": w.flash_crowd(3.0, spike_mult=4.0, t_on=10.0,
                                     t_off=20.0),
        "diurnal": w.diurnal(base_rate=4.0, amplitude=0.5, period=30.0,
                             horizon=60.0, n_bins=12),
    }


@pytest.mark.parametrize("name", list(_processes(rw)))
def test_arrival_process_samples_bitwise(name):
    ref, port = _processes(rw)[name], _processes(tw)[name]
    for seed in (0, 7):
        a = ref.sample(np.random.default_rng(seed), 60.0)
        b = port.sample(np.random.default_rng(seed), 60.0)
        np.testing.assert_array_equal(a, b)
    for f in (0.5, 3.0):
        a = ref.scaled(f).sample(np.random.default_rng(1), 40.0)
        b = port.scaled(f).sample(np.random.default_rng(1), 40.0)
        np.testing.assert_array_equal(a, b)
    for t in (0.0, 9.5, 15.0, 33.3):
        assert ref.rate_at(t) == port.rate_at(t)
    assert ref.mean_rate(60.0) == port.mean_rate(60.0)
    assert ref.rate_bound() == port.rate_bound()


def test_registry_lists_the_reference_catalog():
    assert tw.list_scenarios() == NAMES
    assert len(NAMES) == 12


@pytest.mark.parametrize("name", NAMES)
def test_scenario_generate_and_tensorize_bitwise(name):
    ref, port = rw.get_scenario(name), tw.get_scenario(name)
    kw = dict(seed=3, horizon=min(60.0, ref.horizon), rate_scale=0.7)
    a, b = ref.generate(**kw), port.generate(**kw)
    assert a and [tuple(vars(r).values()) for r in a] == \
        [tuple(vars(r).values()) for r in b]
    ta = ref.tensorize(pad_to=len(a) + 5, **kw)
    tb = port.tensorize(pad_to=len(a) + 5, **kw)
    for f in ("rid", "t", "cls", "P", "D", "patience", "valid"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f),
                                      err_msg=f)
    assert (ta.n_real, ta.n_dropped) == (tb.n_real, tb.n_dropped)
    assert [tuple(vars(e).values()) for e in ref.capacity_events] == \
        [tuple(vars(e).values()) for e in port.capacity_events]
    t = 0.4 * ref.horizon
    np.testing.assert_array_equal(ref.shares_at(t), port.shares_at(t))


def _errors(w, data):
    """The message of each registry/spec error, in order."""
    out = []
    cases = [
        lambda: w.get_scenario("no_such_scenario"),
        lambda: w.register_scenario(
            w.get_scenario("azure_2023").replace(description="shadow")),
        lambda: w.PoissonArrivals(rate=0.0),
        lambda: w.MMPPArrivals(base_rate=1.0, levels=(1.0,), switch=(0.1,)),
        lambda: w.PiecewiseConstantArrivals(times=(1.0, 5.0),
                                            rates=(1.0, 2.0)),
        lambda: w.Scenario(name="bad", description="",
                           arrivals=w.PoissonArrivals(1.0),
                           profiles=(data.ClassProfile("a", 10, 10),),
                           mix_schedule=((0.0, (0.5, 0.5)),)),
        lambda: w.CapacityEvent(t=1.0, kind="melt", sid=0),
        lambda: w.get_scenario("azure_2023").generate(seed=0,
                                                      compression=0.0),
    ]
    for case in cases:
        with pytest.raises((KeyError, ValueError)) as exc:
            case()
        out.append((type(exc.value).__name__, str(exc.value)))
    return out


def test_registry_errors_match_the_reference():
    import repro.data.traces as rd
    import repro_torch.data.traces as td

    assert _errors(tw, td) == _errors(rw, rd)
