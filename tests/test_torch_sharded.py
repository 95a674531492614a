"""The port's cell placement (``repro_torch.sweep.sharded`` and the
``cells_mesh`` / ``shard_cells`` primitives of ``repro_torch.launch.mesh``)
on the CPU.

``plan_shards`` and ``ShardPlan.report()`` are the reference's, held
equal over a grid of cells, devices and budgets.  ``run_sharded`` over
``[cpu] * k`` is held bit for bit to the single batch (the reference's
contract, ``sweep/sharded.py:1-35``), untiled and tiled, with a toy
kernel and with the real engines; the ``single`` / ``vmap`` /
``shard_map`` placements of ``ctmc_jax`` and ``engine_jax`` give equal
cells.  The same placements on the card are ``tests/test_torch_gpu.py``'s.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.sweep import sharded as ref_sharded
from repro_torch.launch.mesh import cells_mesh, shard_cells, shard_cells_fn
from repro_torch.sweep import SweepSpec, run_sweep
from repro_torch.sweep.run import default_mix
from repro_torch.sweep.sharded import (PLACEMENTS, ShardPlan, pad_batch,
                                       plan_shards, run_sharded)


def _grid():
    rng = np.random.default_rng(0)
    for _ in range(150):
        kw = {"n_devices": int(rng.integers(1, 17))}
        if rng.random() < 0.5:
            kw["max_cells_per_device"] = int(rng.integers(1, 64))
        if rng.random() < 0.3:
            kw["bytes_per_cell"] = float(rng.integers(100, 5000))
            kw["memory_budget"] = float(rng.integers(1000, 100000))
        yield int(rng.integers(1, 500)), kw


def test_plan_shards_is_the_reference():
    assert PLACEMENTS == ref_sharded.PLACEMENTS
    for n_cells, kw in _grid():
        got = plan_shards(n_cells, **kw)
        want = ref_sharded.plan_shards(n_cells, **kw)
        assert got.report() == want.report(), (n_cells, kw)
        assert (got.padded, got.n_padding) == (want.padded, want.n_padding)
        assert got.n_padding < got.tile


@pytest.mark.parametrize("args,kw", [
    ((0,), dict(n_devices=2)),
    ((4,), dict(n_devices=2, max_cells_per_device=0)),
    ((4,), dict(n_devices=2, bytes_per_cell=-1.0, memory_budget=8.0)),
])
def test_plan_shards_rejects_what_the_reference_rejects(args, kw):
    with pytest.raises(ValueError):
        ref_sharded.plan_shards(*args, **kw)
    with pytest.raises(ValueError):
        plan_shards(*args, **kw)


def test_shard_plan_rejects_degenerate():
    with pytest.raises(ValueError):
        ShardPlan(n_cells=4, n_devices=0, per_device=1)


def test_pad_batch_repeats_cell_zero():
    rng = np.random.default_rng(1)
    for _ in range(20):
        n = int(rng.integers(1, 12))
        padded = n + int(rng.integers(0, 7))
        tree = {"a": torch.from_numpy(rng.normal(size=(n, 3))),
                "b": (torch.from_numpy(rng.integers(0, 9, size=(n,))),)}
        out = pad_batch(tree, padded)
        for got, src in ((out["a"], tree["a"]), (out["b"][0], tree["b"][0])):
            assert got.shape[0] == padded
            assert torch.equal(got[:n], src)
            for j in range(n, padded):
                assert torch.equal(got[j], got[0])


def _toy(rep, batch):
    """A batch kernel whose cells are independent: a per-cell Philox-free
    pseudo-random walk keyed by the cell's integer key."""
    key, x = batch
    g = torch.sin(key.to(torch.float64)[:, None] * 12.9898
                  + torch.arange(x.shape[1], dtype=torch.float64))
    return {"y": torch.cumsum(rep["w"] * x + g, 1),
            "s": x.sum(1) + rep["b"], "k": key * 2}


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("cap", [None, 1, 2])
@pytest.mark.parametrize("n_cells", [5, 7])
def test_run_sharded_on_k_host_devices_is_the_single_batch(k, cap, n_cells):
    rep = {"w": torch.tensor(1.5, dtype=torch.float64),
           "b": torch.tensor(-0.25, dtype=torch.float64)}
    batch = (torch.arange(n_cells) * 7 + 3,
             torch.linspace(0, 1, n_cells * 4,
                            dtype=torch.float64).reshape(n_cells, 4))
    want = _toy(rep, batch)
    raw, report = run_sharded(_toy, rep, batch, devices=["cpu"] * k,
                              max_cells_per_device=cap)
    plan = ref_sharded.plan_shards(n_cells, n_devices=k,
                                   max_cells_per_device=cap)
    assert report == dict(plan.report(), serialized=k == 1)
    for key in want:
        assert torch.equal(raw[key], want[key]), key


def test_run_sharded_checks_its_plan_and_devices():
    rep = {"w": torch.tensor(1.0), "b": torch.tensor(0.0)}
    batch = (torch.arange(4), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="cells"):
        run_sharded(_toy, rep, batch, devices=["cpu"],
                    plan=plan_shards(5, n_devices=1))
    with pytest.raises(ValueError, match="devices"):
        run_sharded(_toy, rep, batch, devices=["cpu"] * 2,
                    plan=plan_shards(4, n_devices=3))
    with pytest.raises(ValueError, match="empty"):
        run_sharded(_toy, rep, {}, devices=["cpu"])


def test_run_sharded_warns_once_on_one_device():
    """The twin of ``tests/test_sharded.py``'s one-device test: the
    serial run warns once per process, under the ``"shard-serial"`` kind
    it shares with every layer that detects it, then stays quiet."""
    from repro_torch import compat

    rep = {"w": torch.tensor(1.5, dtype=torch.float64),
           "b": torch.tensor(-0.25, dtype=torch.float64)}
    batch = (torch.arange(5) * 7 + 3,
             torch.linspace(0, 1, 20, dtype=torch.float64).reshape(5, 4))
    want = _toy(rep, batch)
    compat.reset_warn_once("shard-serial")
    with pytest.warns(RuntimeWarning, match="1-device mesh"):
        raw, report = run_sharded(_toy, rep, batch, devices=["cpu"])
    assert report["serialized"] and report["n_devices"] == 1
    for key in want:
        assert torch.equal(raw[key], want[key]), key

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        run_sharded(_toy, rep, batch, devices=["cpu"])
        assert not compat.warn_once("shard-serial", "spent")
    assert not [x for x in w if issubclass(x.category, RuntimeWarning)]
    # more than one device is a partitioned run: no warning
    compat.reset_warn_once("shard-serial")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        run_sharded(_toy, rep, batch, devices=["cpu"] * 2)
    assert not [x for x in w if issubclass(x.category, RuntimeWarning)]
    with pytest.warns(RuntimeWarning, match="re-armed"):
        assert compat.warn_once("shard-serial", "re-armed")
    compat.reset_warn_once()


def test_shard_cells_is_strict_and_keeps_cell_order():
    fn = shard_cells_fn(lambda r, b: {"v": b * r}, devices=["cpu"] * 3)
    got = fn(torch.tensor(2), torch.arange(6))
    assert torch.equal(got["v"], torch.arange(6) * 2)
    with pytest.raises(ValueError, match="strict"):
        fn(torch.tensor(2), torch.arange(7))
    out = shard_cells(lambda r, b: b + r, torch.tensor(1), torch.arange(4),
                      devices=["cpu"] * 2)
    assert torch.equal(out, torch.arange(4) + 1)


def test_shard_map_without_a_card_raises():
    """No quiet fallback to vmap: a shard_map with no device list needs
    the CUDA cards."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells_mesh()
    spec = SweepSpec(name="t", evaluator="ctmc_jax", n_servers=(10,),
                     n_seeds=2, mixes=(default_mix(),), horizon=2.0,
                     warmup=0.5, extra={"placement": "shard_map"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(spec, device="cpu")


def _placements(evaluator, **kw):
    base = SweepSpec(name="p", evaluator=evaluator, n_seeds=5, **kw)
    want = [c.metrics for c in run_sweep(base, device="cpu").cells]
    for extra in ({"placement": "single"},
                  {"placement": "shard_map",
                   "shard": {"devices": ["cpu"] * 3}},
                  {"placement": "shard_map",
                   "shard": {"devices": ["cpu"] * 2,
                             "max_cells_per_device": 1}}):
        spec = SweepSpec.from_dict(dict(base.to_dict(), extra=extra))
        res = run_sweep(spec, device="cpu")
        assert [c.metrics for c in res.cells] == want, extra
        if extra["placement"] == "shard_map":
            assert res.meta["shard_devices"] == len(
                extra["shard"]["devices"])


def test_ctmc_jax_placements_are_bitwise():
    _placements("ctmc_jax", policies=("gate_and_route", "sli_aware"),
                n_servers=(10,), mixes=(default_mix(),), horizon=3.0,
                warmup=1.0)


def test_engine_jax_placements_are_bitwise():
    from repro_torch.sweep import MixSpec

    _placements("engine_jax", policies=("vllm",), n_servers=(6,),
                mixes=(MixSpec(name="tr", trace=dict(
                    horizon=2.0, seed=1, compression=0.05)),),
                horizon=2.0, warmup=0.5)


def test_engine_multi_shard_map_is_the_multi_batch():
    """The facade's ``multi`` batch (a leading instance axis of params
    and keys) split over host devices equals the one-call batch."""
    from repro_torch.core.planning import solve_bundled_lp
    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import (Pricing, ServicePrimitives,
                                        WorkloadClass)
    from repro_torch.data.traces import TraceConfig, synth_azure_trace
    from repro_torch.serving import engine_jax as ej
    from repro_torch.serving.engine_sim import EngineConfig

    classes = [WorkloadClass("a", 300, 200, 0.5, 3e-4),
               WorkloadClass("b", 800, 100, 0.3, 3e-4)]
    plan = solve_bundled_lp(classes, ServicePrimitives(), Pricing())
    eng = ej.ClusterEngineJAX(
        classes, gate_and_route(plan),
        EngineConfig(ServicePrimitives(), Pricing(), 4),
        synth_azure_trace(TraceConfig(horizon=2.0, compression=0.05,
                                      seed=2)),
        horizon=2.0, device="cpu")
    params = {k: torch.stack([v] * 3) for k, v in eng.params.items()}
    keys = [eng._key(s) for s in (0, 1, 2)]
    want = ej.run(params, keys, multi=True, **eng.statics)
    got = ej.run(params, keys, multi=True, placement="shard_map",
                 shard={"devices": ["cpu"] * 3}, **eng.statics)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.xfail(strict=True, raises=IndexError,
                   reason="C-ref6: the reference's ClusterEngineJAX."
                          "run_batch_raw(placement='single') hands the "
                          "whole key stack to the one-replication "
                          "run_engine, and summaries_from_raw then fails "
                          "on the unbatched carry")
def test_reference_engine_jax_single_placement_is_its_vmap():
    """The reference's own engine_jax evaluator under ``"single"``; the
    port's equals its vmap batch
    (:func:`test_engine_jax_placements_are_bitwise`)."""
    from repro.sweep import MixSpec as RMix
    from repro.sweep import SweepSpec as RSpec
    from repro.sweep.evaluators import MixContext
    from repro.sweep.spec import cell_seed_sequence, get_evaluator

    mix = RMix(name="tr", trace=dict(horizon=2.0, seed=1, compression=0.05))
    spec = RSpec(name="p", evaluator="engine_jax", policies=("vllm",),
                 n_servers=(6,), n_seeds=2, mixes=(mix,), horizon=2.0,
                 warmup=0.5)
    ctx = MixContext(mix, spec)
    seeds = [cell_seed_sequence(spec, 0, 0, 0, s) for s in range(2)]
    ev = get_evaluator("engine_jax")
    want = [c.metrics for c in ev(ctx, "vllm", 6, seeds=seeds,
                                  placement="vmap")]
    got = [c.metrics for c in ev(ctx, "vllm", 6, seeds=seeds,
                                 placement="single")]
    assert got == want
