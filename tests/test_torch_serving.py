"""The port's real-compute data plane held to the JAX package on the CPU,
for reduced mamba2 and, through the attention mixers, reduced qwen2-0.5b
and gemma2-2b (local ring layers, softcaps).

Mirrors ``tests/test_serving_real.py``: a mixed iteration leaves the
co-resident decode slots alone, and extract/inject keeps the decoded
stream (for attention models, the KV leaves and the int32 ``pos`` leaf
of ring caches travel unchanged).  Then ``RealCluster`` replays the same
requests over the same weights (carried across by ``params_from_numpy``)
in both packages: the decoded tokens are equal and ``summary()`` is
equal.  The reduced configs run in f32, where the two packages differ by
summation order only (1e-5 relative on the logits,
``tests/test_torch_ssm.py`` and ``tests/test_torch_models.py``), so
greedy tokens agree exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.planning import solve_bundled_lp as ref_solve
from repro.core.types import Pricing as RefPricing
from repro.core.types import ServicePrimitives as RefPrim
from repro.core.types import WorkloadClass as RefClass
from repro.models import model as RM
from repro.serving.cluster import RealCluster as RefCluster
from repro_torch.configs import get_config
from repro_torch.core.planning import solve_bundled_lp
from repro_torch.core.types import Pricing, ServicePrimitives, WorkloadClass
from repro_torch.launch.serve import main, serve
from repro_torch.models.params import params_from_numpy, tree_map
from repro_torch.serving.cluster import RealCluster
from repro_torch.serving.engine import ServerEngine, SlotRequest
from repro_torch.serving.steps import (init_server_state, make_decode_step,
                                       make_mixed_step, make_prefill_step)

ARCH = "mamba2-130m"
ATTN_ARCHS = ["qwen2-0.5b", "gemma2-2b"]


def _mk(arch=ARCH):
    ref_cfg = ref_get_config(arch, reduced=True)
    rp = jax.tree.map(np.asarray, RM.init_model(ref_cfg,
                                                jax.random.PRNGKey(0)))
    return ref_cfg, get_config(arch, reduced=True), rp, \
        params_from_numpy(rp, "cpu")


def test_mixed_step_prefill_isolation():
    """A mixed iteration must not corrupt co-resident decode slots."""
    _, cfg, _, params = _mk()
    B, max_len, C = 4, 128, 16
    mixed = make_mixed_step(cfg, C)
    dec = make_decode_step(cfg)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, 8)).astype(
        np.int32))
    chunk = torch.from_numpy(rng.integers(2, cfg.vocab_size, C).astype(
        np.int32))

    # two engines with the same two active decode slots; one also prefills
    def setup():
        st = init_server_state(cfg, B, max_len, torch.float32, "cpu")
        pos = torch.arange(8, dtype=torch.int32)[None].expand(B, 8)
        caches, nxt = make_prefill_step(cfg)(params, st["caches"], toks, pos)
        return dict(st, caches=caches,
                    length=torch.full((B,), 8, dtype=torch.int32),
                    last_token=nxt,
                    active=torch.tensor([True, True, False, False]))

    s_solo = dec(params, setup())[0]
    before = setup()
    # the step writes the caches it is given: it gets a copy
    s_mixed, dec_tokens, _ = mixed(params, tree_map(torch.clone, before), 3,
                                   chunk,
                                   torch.zeros((1, 1), dtype=torch.int32),
                                   kv_len=C)
    # decode slots 0 and 1 advanced identically in both modes
    assert torch.equal(s_solo["last_token"][:2], s_mixed["last_token"][:2])
    assert torch.equal(s_solo["length"][:2], s_mixed["length"][:2])
    for k in ("conv", "ssm"):
        solo, mix = s_solo["caches"][0]["b0"][k], s_mixed["caches"][0]["b0"][k]
        assert torch.equal(solo[:, :2], mix[:, :2])
        # the idle slot is untouched; the prefilled slot took the chunk
        assert torch.equal(mix[:, 2], before["caches"][0]["b0"][k][:, 2])
        assert not torch.equal(mix[:, 3], before["caches"][0]["b0"][k][:, 3])
    assert bool(s_mixed["active"][:2].all()) and not s_mixed["active"][3]


def test_state_migration_preserves_tokens():
    """extract_slot/inject_slot must not change the decoded stream."""
    _, cfg, _, params = _mk()
    prim = ServicePrimitives(batch_cap=4, chunk=16)

    def engine():
        return ServerEngine(cfg, params, prim=prim, max_len=128,
                            device="cpu")

    toks = np.random.default_rng(0).integers(2, cfg.vocab_size,
                                             size=24).astype(np.int32)
    eng_a, eng_b = engine(), engine()
    req = SlotRequest(rid=0, cls=0, prompt_len=24, decode_len=6)
    eng_a.start_prefill(req, toks)
    while eng_a.has_prefill:
        eng_a.step()
    slot = next(i for i, s in enumerate(eng_a.slots) if s is req)
    _, sub, meta = eng_a.extract_slot(slot)
    assert all(a.device.type == "cpu" for a in sub[0]["b0"].values())
    eng_b.inject_slot(2, req, sub, meta)
    while req.tokens_out < req.decode_len:
        eng_b.step()

    # reference: same request decoded without migration
    req2 = SlotRequest(rid=1, cls=0, prompt_len=24, decode_len=6)
    eng_c = engine()
    eng_c.start_prefill(req2, toks)
    while eng_c.has_prefill:
        eng_c.step()
    slot2 = next(i for i, s in enumerate(eng_c.slots) if s is req2)
    eng_c.activate_slot(slot2)
    while req2.tokens_out < req2.decode_len:
        eng_c.step()
    assert req.out_tokens == req2.out_tokens and len(req.out_tokens) == 6


def _record_completions(cluster):
    """Collect every completed request from the cluster's engines."""
    done = []
    for eng in cluster.engines:
        def step(orig=eng.step):
            res = orig()
            done.extend(res["completed"])
            return res
        eng.step = step
    return done


def _requests(vocab, classes, n, seed):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for k in range(n):
        t += rng.exponential(0.5)
        c = k % 2
        toks = rng.integers(2, vocab, size=classes[c][1]).astype(np.int32)
        reqs.append((t, c, toks, classes[c][2]))
    return reqs


def test_real_cluster_matches_the_reference():
    ref_cfg, cfg, rp, tp = _mk()
    spec = [("a", 24, 6, 0.5, 0.1), ("b", 8, 12, 0.5, 0.1)]
    reqs = _requests(cfg.vocab_size, spec, 6, seed=1)

    def run(Cluster, solve, Prim, Pr, Cls, c, params, **kw):
        prim, pricing = Prim(batch_cap=4, chunk=16), Pr()
        classes = [Cls(*s) for s in spec]
        plan = solve(classes, prim, pricing)
        cl = Cluster(c, params, classes, plan, prim, pricing, n_servers=2,
                     max_len=128, **kw)
        done = _record_completions(cl)
        m = cl.run(reqs, horizon=500.0)
        return m, {r.rid: r.out_tokens for r in done}

    want, want_toks = run(RefCluster, ref_solve, RefPrim, RefPricing,
                          RefClass, ref_cfg, rp)
    got, got_toks = run(RealCluster, solve_bundled_lp, ServicePrimitives,
                        Pricing, WorkloadClass, cfg, tp, device="cpu")
    assert got.completions == 6 and got.revenue > 0
    assert got.summary() == want.summary()
    assert got_toks == want_toks
    assert sorted(len(t) for t in got_toks.values()) == [6, 6, 6, 12, 12, 12]
    walls = got.iter_wall
    assert len(walls["mixed"]) >= 6 and len(walls["solo"]) > 0
    assert all(w > 0 for w in walls["mixed"] + walls["solo"])


def test_serve_runs_reduced_mamba2_on_the_cpu(capsys):
    m = serve(get_config(ARCH, reduced=True), servers=2, requests=4,
              device="cpu")
    assert m.completions == m.arrivals == 4
    assert "LP plan" in capsys.readouterr().out


# ------------------------------------------------------- attention models


def _leaves(tree):
    return [a for seg in tree for blk in seg.values() for a in blk.values()]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_mixed_step_prefill_isolation(arch):
    """A mixed iteration (a continuation chunk on slot 3) must not corrupt
    the co-resident decode slots' KV caches."""
    _, cfg, _, params = _mk(arch)
    B, max_len, C = 4, 128, 16
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, 40)).astype(
        np.int32))  # past the reduced window: the rings wrap
    chunk = torch.from_numpy(rng.integers(2, cfg.vocab_size, C).astype(
        np.int32))

    def setup():
        st = init_server_state(cfg, B, max_len, torch.float32, "cpu")
        pos = torch.arange(40, dtype=torch.int32)[None].expand(B, 40)
        caches, nxt = make_prefill_step(cfg)(params, st["caches"], toks, pos)
        return dict(st, caches=caches,
                    length=torch.full((B,), 40, dtype=torch.int32),
                    last_token=nxt,
                    active=torch.tensor([True, True, False, False]))

    s_solo = make_decode_step(cfg)(params, setup())[0]
    before = setup()
    s_mixed, _, _ = make_mixed_step(cfg, C)(
        params, tree_map(torch.clone, before), 3, chunk,
        torch.zeros((1, 1), dtype=torch.int32), kv_len=C)
    assert torch.equal(s_solo["last_token"][:2], s_mixed["last_token"][:2])
    assert torch.equal(s_solo["length"][:2], s_mixed["length"][:2])
    for solo, mix, old in zip(_leaves(s_solo["caches"]),
                              _leaves(s_mixed["caches"]),
                              _leaves(before["caches"])):
        assert torch.equal(solo[:, :2], mix[:, :2])
        assert torch.equal(mix[:, 2], old[:, 2])  # the idle slot
    # the chunk landed in slot 3: new keys, its positions 0..15 in every
    # layer (in the rings, over positions the prompt had left there)
    for seg, old in zip(s_mixed["caches"], before["caches"]):
        for blk, old_blk in zip(seg.values(), old.values()):
            assert not torch.equal(blk["k"][:, 3], old_blk["k"][:, 3])
            assert set(range(C)) <= set(blk["pos"][:, 3].flatten().tolist())
    assert bool(s_mixed["active"][:2].all()) and not s_mixed["active"][3]


@pytest.mark.parametrize("arch,kv_quant", [(a, False) for a in ATTN_ARCHS]
                         + [("qwen2-0.5b", True)])
def test_attention_kv_migration_preserves_tokens(arch, kv_quant):
    """extract_slot/inject_slot carry the KV and ``pos`` leaves unchanged
    (int8 values and f16 scales too) and keep the decoded stream."""
    _, cfg, _, params = _mk(arch)
    cfg = cfg.replace(kv_quant=kv_quant)
    prim = ServicePrimitives(batch_cap=4, chunk=16)

    def engine():
        return ServerEngine(cfg, params, prim=prim, max_len=128,
                            device="cpu")

    toks = np.random.default_rng(0).integers(2, cfg.vocab_size,
                                             size=40).astype(np.int32)
    eng_a, eng_b = engine(), engine()
    req = SlotRequest(rid=0, cls=0, prompt_len=40, decode_len=8)
    eng_a.start_prefill(req, toks)
    while eng_a.has_prefill:
        eng_a.step()
    slot = next(i for i, s in enumerate(eng_a.slots) if s is req)
    kept = [a[:, slot:slot + 1].clone()
            for a in _leaves(eng_a.state["caches"])]
    _, sub, meta = eng_a.extract_slot(slot)
    eng_b.inject_slot(2, req, sub, meta)
    for want, got in zip(kept, _leaves(eng_b.state["caches"])):
        assert got.dtype == want.dtype and torch.equal(got[:, 2:3], want)
    while req.tokens_out < req.decode_len:
        eng_b.step()

    req2 = SlotRequest(rid=1, cls=0, prompt_len=40, decode_len=8)
    eng_c = engine()
    eng_c.start_prefill(req2, toks)
    while eng_c.has_prefill:
        eng_c.step()
    slot2 = next(i for i, s in enumerate(eng_c.slots) if s is req2)
    eng_c.activate_slot(slot2)
    while req2.tokens_out < req2.decode_len:
        eng_c.step()
    assert req.out_tokens == req2.out_tokens and len(req.out_tokens) == 8


@pytest.mark.parametrize("arch", ATTN_ARCHS + [
    "paligemma-3b", "deepseek-v3-671b", "grok-1-314b"])
def test_attention_real_cluster_matches_the_reference(arch):
    """Prompts of 40 tokens (three chunks, past the reduced window) and 8;
    the same tokens and ``summary()`` as the JAX ``RealCluster``.  The
    engine serves paligemma text only, as the reference's does, and
    deepseek-v3 through MLA and the MoE."""
    ref_cfg, cfg, rp, tp = _mk(arch)
    spec = [("a", 40, 6, 0.5, 0.1), ("b", 8, 12, 0.5, 0.1)]
    reqs = _requests(cfg.vocab_size, spec, 6, seed=1)

    def run(Cluster, solve, Prim, Pr, Cls, c, params, **kw):
        prim, pricing = Prim(batch_cap=4, chunk=16), Pr()
        classes = [Cls(*s) for s in spec]
        plan = solve(classes, prim, pricing)
        cl = Cluster(c, params, classes, plan, prim, pricing, n_servers=2,
                     max_len=128, **kw)
        done = _record_completions(cl)
        m = cl.run(reqs, horizon=500.0)
        return m, {r.rid: r.out_tokens for r in done}

    want, want_toks = run(RefCluster, ref_solve, RefPrim, RefPricing,
                          RefClass, ref_cfg, rp)
    got, got_toks = run(RealCluster, solve_bundled_lp, ServicePrimitives,
                        Pricing, WorkloadClass, cfg, tp, device="cpu")
    assert got.completions == 6 and got.revenue > 0
    assert got.summary() == want.summary()
    assert got_toks == want_toks


def test_serve_main_runs_the_default_arch_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` serves its default arch,
    qwen2-0.5b (reduced), as the reference's ``launch/serve.py`` does."""
    main(["--device", "cpu", "--servers", "2", "--requests", "4"])
    out = capsys.readouterr().out
    assert "LP plan" in out and "completions: 4" in out
