"""The port's parallel training pieces held to the JAX package on the CPU.

``training.compress`` (int8 error feedback), ``training.pipeline``
(GPipe forward), ``training.sharding``, ``models.params``' partition
specs and the shape-only meshes (``compat.make_mesh``,
``launch.mesh.make_production_mesh``) against ``repro``'s.  The
collectives run over ``torch.distributed``'s gloo backend: one rank in
this process, or two ranks in subprocesses (``RANKS``), which import
torch and the port only.

Tolerances: int8 quantisation and the compressed mean bitwise (the
reference's arithmetic, op for op); the 50-step error-feedback mean at
the reference test's 2e-3; the pipeline at 1e-5 against a sequential
run of the stages (f32 matmuls); partition specs and rules equal.
"""

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS, get_config as ref_get_config
from repro.models import model as RM
from repro.models import params as RP
from repro.training import compress as RC
from repro.training import sharding as RS
from repro.training.pipeline import bubble_fraction as ref_bubble
from repro_torch.compat import make_mesh
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.training import sharding as TS
from repro_torch.training.compress import (dequantize_int8, init_residuals,
                                           make_compressed_psum,
                                           quantize_int8)
from repro_torch.training.pipeline import bubble_fraction

ROOT = Path(__file__).resolve().parents[1]
N_MICRO, D = 3, 8

RANK = r"""
import json, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
from repro_torch.training.compress import make_compressed_psum
from repro_torch.training.pipeline import make_pipeline_forward

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
try:
    rng = np.random.default_rng(rank)
    g = {"w": rng.standard_normal((5, 7)).astype(np.float32),
         "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    r = {"w": rng.standard_normal((5, 7)).astype(np.float32) * 1e-3,
         "b": {"c": np.zeros(11, np.float32)}}
    tt = lambda t: {k: tt(v) if isinstance(v, dict) else torch.from_numpy(v)
                    for k, v in t.items()}
    mean, res = make_compressed_psum()(tt(g), tt(r))
    W = (np.random.default_rng(100).standard_normal(
        (world, %(D)d, %(D)d)) / np.sqrt(%(D)d)).astype(np.float32)
    xs = np.random.default_rng(101).standard_normal(
        (%(N_MICRO)d, 2, %(D)d)).astype(np.float32)
    f = make_pipeline_forward(lambda w, x, sid: x @ w[0],
                              n_micro=%(N_MICRO)d)
    pipe = f(torch.from_numpy(W[rank:rank + 1]), torch.from_numpy(xs))
    np.savez(f"{out}/rank{rank}.npz", mean_w=mean["w"].numpy(),
             mean_c=mean["b"]["c"].numpy(), res_w=res["w"].numpy(),
             res_c=res["b"]["c"].numpy(), pipe=pipe.numpy())
finally:
    dist.destroy_process_group()
""" % {"D": D, "N_MICRO": N_MICRO}
RANKS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The rank script's results on 2 gloo ranks, one subprocess each."""
    out = tmp_path_factory.mktemp("ranks")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(RANKS), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, o + e
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process, torn down after."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("seed,shape,scale", [(0, (64, 64), 1.0),
                                              (1, (1000,), 1e-3),
                                              (2, (3, 5, 7), 300.0),
                                              (3, (16,), 0.0)])
def test_quantize_int8_is_the_reference(seed, shape, scale):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    back = dequantize_int8(q, s)
    assert back.numpy().tobytes() == np.asarray(
        RC.dequantize_int8(rq, rs)).tobytes()
    # quantisation error bounded by scale/2 per element
    assert float((back - torch.from_numpy(x)).abs().max()) \
        <= float(s) * 0.5 + 1e-6


def test_compressed_psum_preserves_mean_with_feedback(one_rank):
    """Over repeated steps, error feedback keeps the compressed mean
    unbiased: accumulated residuals stay bounded (the reference's test
    on a one-rank group)."""
    f = make_compressed_psum()
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(32,))
                               .astype(np.float32))}
    r = init_residuals(g)
    assert r["w"].dtype == torch.float32 and not r["w"].any()
    total = torch.zeros(32)
    for _ in range(50):
        mean, r = f(g, r)
        total = total + mean["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(),
                               atol=2e-3)


def test_compressed_psum_over_two_ranks(two_ranks):
    """Every rank gets the reference's compressed mean of the two ranks'
    grads bit for bit (its formula on each rank's quantised payload),
    within the formula's error bound of the arithmetic mean, and its own
    error-feedback residual."""
    grads, ress = [], []
    for rank in range(RANKS):
        rng = np.random.default_rng(rank)
        grads.append({"w": rng.standard_normal((5, 7)).astype(np.float32),
                      "c": rng.standard_normal(11).astype(np.float32)})
        ress.append({"w": rng.standard_normal((5, 7)).astype(np.float32)
                     * 1e-3, "c": np.zeros(11, np.float32)})
    for key in ("w", "c"):
        summed = [jnp.asarray(g[key]) + jnp.asarray(r[key])
                  for g, r in zip(grads, ress)]
        qs = [RC.quantize_int8(x) for x in summed]
        qsum = sum(q.astype(jnp.int32) for q, _ in qs)
        ssum = sum(s for _, s in qs)
        want = np.asarray(qsum.astype(jnp.float32) * (ssum / RANKS) / RANKS)
        exact = np.mean([np.asarray(x) for x in summed], axis=0)
        # the payloads are dequantised at the mean scale: each rank's
        # term is off by |q| |mean scale - its scale| plus its rounding
        s_bar = float(ssum) / RANKS
        bound = sum(127 * abs(s_bar - float(s)) + float(s) / 2
                    for _, s in qs) / RANKS
        for rank, got in enumerate(two_ranks):
            assert got[f"mean_{key}"].tobytes() == want.tobytes()
            np.testing.assert_allclose(got[f"mean_{key}"], exact, rtol=0,
                                       atol=bound * (1 + 1e-6))
            q, s = qs[rank]
            res = np.asarray(summed[rank] - RC.dequantize_int8(q, s))
            assert got[f"res_{key}"].tobytes() == res.tobytes()


def test_pipeline_forward_matches_sequential(two_ranks):
    """The GPipe loop over 2 stages and 3 microbatches equals the stages
    run one after another, on every rank (the last stage's outputs are
    broadcast)."""
    W = (np.random.default_rng(100).standard_normal(
        (RANKS, D, D)) / np.sqrt(D)).astype(np.float32)
    xs = np.random.default_rng(101).standard_normal(
        (N_MICRO, 2, D)).astype(np.float32)
    ref = xs
    for s in range(RANKS):
        ref = np.einsum("mbd,de->mbe", ref, W[s])
    for got in two_ranks:
        np.testing.assert_allclose(got["pipe"], ref, atol=1e-5, rtol=1e-5)


def test_pipeline_forward_on_one_stage(one_rank):
    from repro_torch.training.pipeline import make_pipeline_forward

    xs = torch.randn(4, 2, D, generator=torch.Generator().manual_seed(0))
    w = torch.randn(1, D, D, generator=torch.Generator().manual_seed(1))
    out = make_pipeline_forward(lambda p, x, sid: x @ p[0], n_micro=4)(w, xs)
    torch.testing.assert_close(out, xs @ w[0], rtol=0, atol=0)


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert abs(bubble_fraction(4, 12) - 3 / 15) < 1e-12
    assert bubble_fraction(8, 8) == 7 / 15
    for s, m in ((2, 3), (16, 64), (5, 1)):
        assert bubble_fraction(s, m) == ref_bubble(s, m)


def _ref_mesh(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    return mesh, AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)


def test_production_meshes_are_the_reference_shapes():
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        mesh, ref = _ref_mesh(multi_pod)
        assert mesh.shape == shape and dict(ref.shape) == shape
        assert mesh.axis_names == tuple(shape)
    with pytest.raises(ValueError, match="one distinct name per axis"):
        make_mesh((2, 2), ("data",))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_partition_specs_match_reference(arch, multi_pod):
    """Rules (FSDP on and off, with an override), the divisibility
    demotion, the specs of every leaf, the batch spec and the state
    shardings of each config at its published size on both production
    meshes."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    mesh, rmesh = _ref_mesh(multi_pod)
    defs = TM.model_defs(get_config(arch))
    rdefs = RM.model_defs(ref_get_config(arch))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for kw in ({}, {"fsdp": False}, {"fsdp_axis": ("pod", "data")
                                     if multi_pod else "data",
                                     "overrides": {"heads": None}}):
        rules = TS.auto_demote(defs, TS.make_rules(mesh, **kw), mesh)
        rrules = RS.auto_demote(rdefs, RS.make_rules(rmesh, **kw), rmesh)
        assert rules == rrules
        specs = TP.partition_specs(defs, rules)
        rspecs = RP.partition_specs(rdefs, rrules)
        flat = jax.tree_util.tree_leaves_with_path(rspecs, is_leaf=is_spec)
        got = jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, tuple))
        assert [p for p, _ in got] == [p for p, _ in flat]
        for (_, g), (path, w) in zip(got, flat):
            assert g == tuple(w), path
    assert TS.batch_spec(mesh) == tuple(RS.batch_spec(rmesh))
    sh = TS.state_shardings(defs, mesh, rules)
    assert jax.tree.structure(
        sh, is_leaf=lambda x: isinstance(x, TS.NamedSharding)) \
        == jax.tree.structure(specs, is_leaf=lambda x: isinstance(x, tuple))
    for s, spec in zip(
            jax.tree.leaves(sh,
                            is_leaf=lambda x: isinstance(x, TS.NamedSharding)),
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tuple))):
        assert s.mesh is mesh and s.spec == spec


def test_default_rules_and_abstract_params():
    assert TP.DEFAULT_RULES == RP.DEFAULT_RULES
    cfg = get_config("deepseek-v3-671b")
    rdefs = RM.model_defs(ref_get_config("deepseek-v3-671b"))
    ab = TP.abstract_params(TM.model_defs(cfg), torch.bfloat16)
    want = RP.abstract_params(rdefs, jnp.bfloat16)
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree.leaves(ab))
    for path, w in flat:
        g = ab
        for k in path:
            g = g[k.key]
        assert g.device.type == "meta" and g.dtype == torch.bfloat16
        assert tuple(g.shape) == w.shape, path
    assert sum(t.numel() for t in jax.tree.leaves(ab)) == TM.param_count(cfg)
