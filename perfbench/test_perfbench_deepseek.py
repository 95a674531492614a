"""The ``deepseek`` family's plain reference against the program on the
CPU, at the cell's configuration cut to a small size: the tree of
weights, the published router, latent attention with its norms and YaRN
through a whole prefill, continuation chunks and decodes, a served run,
and the ``moe_dispatch_fill`` reader."""

import copy
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.conftest import StepClock
from perfbench.reference import deepseek as ref

ROOT = Path(__file__).resolve().parent.parent
CELL = "deepseek-v3-7l.azure_steady_dsv3"
BENCH = harness.load_bench(ROOT)


def tiny(dtype="float32", n_layers=4, dense=1):
    """The cell's files at a CPU size: every key and code path kept, the
    router 16 wide over 4 groups keeping 2, 4 experts held, top 4."""
    cfg = copy.deepcopy(harness.load_config("deepseek-v3-7l"))
    m = cfg["model"]
    m.update(d_model=64, d_ff=96, vocab_size=512, max_seq_len=256,
             param_dtype=dtype, n_layers=n_layers, moe_start_layer=dense)
    m["mla"].update(n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    m["mla"]["yarn"].update(original_max_len=32)  # the ramp bites at 8 dims
    m["moe"].update(n_experts=4, router_experts=16, top_k=4, n_groups=4,
                    topk_groups=2, d_ff_expert=32, capacity_factor=4.0)
    cfg["serving"].update(batch_cap=8, chunk=32, max_len=256, max_prompt=160,
                          max_output=64, weight_dtype=dtype,
                          cache_dtype=dtype)
    cfg["primitives"].update(alpha=0.01, beta=0.0, gamma=150.0)
    cfg["check"] = {"limits": {"widest_gap_untied": 1e-3}, "tie_margin": 0.0}
    mix = copy.deepcopy(harness.traffic.load_mix("azure_steady_dsv3"))
    for c, p, d in zip(mix["classes"], (80, 40), (8, 20)):
        c["prompt"]["mean"], c["output"]["mean"] = p, d
    mix.update(rate=25.0, lead_s=0.3)
    return cfg, mix


def test_the_cell_loads_with_the_published_router_and_widths():
    mcfg = harness._model_config(harness.load_config("deepseek-v3-7l"))
    e, a = mcfg.moe, mcfg.mla
    assert (e.router_experts, e.n_experts, e.top_k, e.n_groups,
            e.topk_groups, e.routed_scale) == (256, 8, 8, 8, 4, 2.5)
    assert (mcfg.d_model, mcfg.d_ff, e.d_ff_expert, a.n_heads,
            a.q_lora_rank, a.kv_lora_rank, a.qk_nope_dim, a.qk_rope_dim,
            a.v_head_dim, mcfg.vocab_size) == (7168, 18432, 2048, 128, 1536,
                                               512, 128, 64, 128, 129280)
    assert e.scoring == "sigmoid" and a.latent_norms
    # nothing drops: the capacity over T tokens is T
    from repro_torch.models.moe import _capacity
    assert [_capacity(e, t) for t in (64, 512, 576)] == [64, 512, 576]


@pytest.mark.parametrize("layers,dense", [(4, 1), (7, 3), (3, 0)])
def test_weights_have_the_programs_tree(layers, dense):
    cfg, _ = tiny(n_layers=layers, dense=dense)
    harness._check_layout(harness._model_config(cfg),
                          ref.make_params(cfg, 5, "cpu"))


def test_yarn_frequencies_and_scale_are_the_published_ones():
    from repro_torch.models.config import YaRNConfig
    from repro_torch.models.layers import _rope_freqs
    from repro_torch.models.mla import _softmax_scale

    a = harness.load_config("deepseek-v3-7l")["model"]["mla"]
    f0 = 10000.0 ** (-np.arange(0, 64, 2) / 64)
    # the ramp runs over [floor corr(32), ceil corr(1)] = [10, 23]
    ramp = np.clip((np.arange(32) - 10) / 13, 0, 1)
    want = f0 / 40 * ramp + f0 * (1 - ramp)
    got = _rope_freqs(64, 10000.0, torch.device("cpu"),
                      YaRNConfig(**a["yarn"])).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    np.testing.assert_allclose(ref.rope_freqs(64, 1e4, a["yarn"]).numpy(),
                               want, rtol=2e-6)
    assert got[10] == pytest.approx(f0[10], rel=1e-6)
    assert got[23] == pytest.approx(f0[23] / 40, rel=1e-6)
    mcfg = harness._model_config(harness.load_config("deepseek-v3-7l"))
    assert _softmax_scale(mcfg.mla) == pytest.approx(0.135234, abs=5e-7)
    assert ref._softmax_scale(a) == pytest.approx(0.135234, abs=5e-7)


def _router(seed, **over):
    cfg, _ = tiny()
    e = dict(cfg["model"]["moe"], **over)
    p = ref.make_params(cfg, seed, "cpu")["seg0"]["b1"]["moe"]
    p = {k: v[0] for k, v in p.items() if k != "shared"}
    x = torch.randn(300, 64, generator=torch.Generator().manual_seed(seed))
    return e, p, x


@pytest.mark.parametrize("seed", [1, 2])
def test_router_equals_the_reference(seed):
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import _route

    e, p, x = _router(seed)
    w, idx = _route(MoEConfig(**e), p, x)
    rw, ridx = ref.route(x, {k: v[None] for k, v in p.items()}, 0, e,
                         ref._Ops("f32"))
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(w, rw, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(w.sum(-1), torch.full((300,), 2.5))
    # each part bites: without the bias, or without the group mask, other
    # experts are chosen; every choice lies in the 2 best groups
    no_bias = dict(p, router_bias=torch.zeros_like(p["router_bias"]))
    for cfg, pp in ((MoEConfig(**e), no_bias),
                    (MoEConfig(**dict(e, n_groups=1)), p)):
        _, other = _route(cfg, pp, x)
        assert not torch.equal(other, idx)
    groups = idx // 4
    assert (torch.stack([(groups == g).any(-1) for g in range(4)])
            .sum(0) <= 2).all()


def test_router_margins_cover_the_expert_and_the_group_cut():
    """Margins in router logits: the score gap at each cut over the mean
    slope of the two scores; the lesser of the expert and the group cut."""
    e, p, x = _router(3)
    pp = {k: v[None] for k, v in p.items()}
    mg = []
    ref.route(x, pp, 0, e, ref._Ops("f32"), margins=mg)
    s = torch.sigmoid(x @ p["router"])
    sel, slope = s + p["router_bias"], s * (1 - s)
    best, at = sel.view(-1, 4, 4).topk(2, -1)
    gs, gsl = best.sum(-1), slope.view(-1, 4, 4).gather(2, at).sum(-1)
    order = gs.argsort(-1, descending=True)
    g2, g3 = gs.gather(1, order[:, 1:3]).unbind(-1)
    cut = 2 * (g2 - g3) / gsl.gather(1, order[:, 1:3]).sum(-1)
    assert (mg[0] <= cut + 1e-5).all()
    assert (mg[0] < cut - 1e-5).any()  # the expert cut too
    mg1 = []
    ref.route(x, pp, 0, dict(e, n_groups=1), ref._Ops("f32"), margins=mg1)
    v, i = sel.sort(-1, descending=True)
    sl = slope.gather(1, i)
    torch.testing.assert_close(mg1[0], 2 * (v[:, 3] - v[:, 4])
                               / (sl[:, 3] + sl[:, 4]))


def _prefill_chunks_decodes(cfg, params, toks, cuts, n_dec, cut=False):
    """The program's logits at the end of a whole prefill, of each
    continuation chunk, and at each decode; ``cut``: each chunk's latent
    attention stops at its end (``kv_len``), as the engine's does."""
    from repro_torch.models import model as M

    mcfg = harness._model_config(cfg)
    caches = M.init_cache(mcfg, 1, 256, dtype=torch.float32, device="cpu")
    out, pos = [], []
    for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
        lg, caches = M.forward_prefill(
            mcfg, params, toks[None, a:b],
            torch.arange(a, b)[None], caches, continuation=i > 0,
            kv_len=b if cut else None)
        out.append(lg[0, -1])
        pos.append(b - 1)
    for j in range(n_dec):
        t = cuts[-1] + j
        lg, caches = M.forward_decode(mcfg, params, toks[None, t:t + 1],
                                      torch.tensor([t]), caches)
        out.append(lg[0, -1])
        pos.append(t)
    return torch.stack(out), pos


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "kv_len"])
def test_mla_prefill_chunks_and_decodes_equal_the_reference(cut):
    """Latent norms and YaRN on all three paths: a whole prefill of 40
    tokens, two continuation chunks over the cache (read whole, or to the
    chunk's end), three absorbed decodes; at capacity factor
    router_experts / top_k nothing drops, so the chunks route as the
    whole sequence does."""
    cfg, _ = tiny()
    cfg["model"]["moe"]["capacity_factor"] = 4.0  # 16 / 4
    params = ref.make_params(cfg, 7, "cpu")
    toks = torch.randint(0, 512, (83,),
                         generator=torch.Generator().manual_seed(7))
    got, pos = _prefill_chunks_decodes(cfg, params, toks, (0, 40, 57, 80), 3,
                                       cut)
    want = ref.served_logits(cfg, params, [toks], [np.asarray(pos)])[0]
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)
    # the norms and YaRN bite: the reference without them is far off
    for off in ({"latent_norms": False}, {"yarn": None}):
        c2 = copy.deepcopy(cfg)
        c2["model"]["mla"].update(off)
        other = ref.served_logits(c2, params, [toks], [np.asarray(pos)])[0]
        assert (other - want).abs().max() > 1e-2, off


def test_served_logits_equal_the_programs_forward():
    from repro_torch.models import model as M

    cfg, _ = tiny(n_layers=7, dense=3)
    params = ref.make_params(cfg, 11, "cpu")
    mcfg = harness._model_config(cfg)
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, 512, (n,), generator=g) for n in (37, 90)]
    want = [np.arange(n) for n in (37, 90)]
    for s, r in zip(seqs, ref.served_logits(cfg, params, seqs, want)):
        got, _ = M.forward_train(mcfg, params, s[None])
        torch.testing.assert_close(got[0].float(), r, atol=2e-4, rtol=1e-4)


def _run(cfg, mix, seed=2**33 + 9, trace=False):
    return harness.run_cell(BENCH, CELL, seed=seed, seconds=1.5, trace=trace,
                            device="cpu", cfg=cfg, mix=mix,
                            log=lambda s: None, clock=StepClock())


def test_a_tiny_cell_serves_what_the_reference_computes():
    res = _run(*tiny())
    assert res["correct"], res["checks"]
    assert res["attempted"] > 5
    assert set(res["metrics"]) == {"tpot_p95_ms", "revenue_per_s",
                                   "setup_s"}


def test_the_control_reads_above_the_program_in_bf16():
    """The fp8 control and the program, both against the f32 reference,
    at the small size in the served bf16. The router is widened to the
    spread its logits have at d_model 7168 (std 0.02 sqrt(7168))."""
    cfg, mix = tiny("bfloat16")
    cell = harness.Cell(BENCH, CELL, 3, "cpu", cfg=cfg, mix=mix)
    for seg in cell.params.values():
        for b in (seg.values() if isinstance(seg, dict) else ()):
            if isinstance(b, dict) and "moe" in b:
                b["moe"]["router"].mul_(math.sqrt(7168 / 64))
    classes, _, gate = cell.plan(mix["rate"])
    rec = cell.serve(cell.engine(), gate, len(classes), 3, 1.5, mix["rate"],
                     clock=StepClock())
    picked = check.sample(rec.requests, 3, max_tokens=harness.SAMPLE_TOKENS,
                          min_served=harness.SAMPLE_SERVED)
    margins = []
    g, c = check.token_gaps(torch, ref, cfg, cell.params, picked, "cpu",
                            control=True, margins=margins)
    keep = check.untied(margins, 0.1)
    assert keep.mean() > 0.3
    assert c[keep].max() > 3 * g[keep].max()


def _reader():
    spec = importlib.util.spec_from_file_location(
        "fill", ROOT / "perfbench" / "layers" / "moe_dispatch_fill.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_fill_reader_reads_the_counter():
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import apply_moe
    from repro_torch.telemetry import counters

    read = _reader()
    cfg, _ = tiny()
    run = harness.Run(None, cfg, None, None, None)
    dense = harness.Run(None, {"model": dict(cfg["model"], moe=None)},
                        None, None, None)
    counters.reset()
    assert read(run) == 0.0  # MoE layers, nothing counted: the worst value
    assert read(dense) is None  # no MoE layer: nothing to read
    e, p, x = _router(4)
    full = ref.make_params(cfg, 4, "cpu")["seg0"]["b1"]["moe"]
    p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
         for k, v in full.items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        apply_moe(MoEConfig(**e), p, x[None])
    _, idx = ref.route(x, {k: v[None] for k, v in p.items()
                           if k != "shared"}, 0, e, ref._Ops("f32"))
    kept = int((idx < 4).sum())
    cap = math.ceil(300 * 4 / 16 * 4.0 / 8) * 8
    assert read(run) == pytest.approx(100.0 * kept / (4 * cap))
    assert read(dense) is None
    counters.reset()


def test_limits_ties_keeps_counts_and_reads_none_where_nothing_is_kept():
    from perfbench import limits_ties

    g = np.array([0.1, 0.5, 0.2, 0.3])
    m = np.array([0.0, 0.01, 0.06, 0.15])
    got = limits_ties.stats(g, m, ties=(0.0, 0.05, 0.1, 0.2))
    assert got["widest"] == 0.5 and got["positions"] == 4
    assert [got[f"kept_{t}"] for t in (0.0, 0.05, 0.1, 0.2)] == [4, 2, 1, 0]
    assert got["widest_untied_0.05"] == 0.3
    assert got["widest_untied_0.1"] == 0.3
    assert got["widest_untied_0.2"] is None
    assert got["share_tied_0.2"] == 1.0


def test_limits_ties_runs_limits_main_with_its_margins(monkeypatch):
    from perfbench import limits_ties

    monkeypatch.setattr("sys.path", list(__import__("sys").path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from perfbench import limits

    monkeypatch.setattr(limits, "TIES", limits.TIES)
    monkeypatch.setattr(limits, "_stats", limits._stats)
    assert limits_ties.main(["--workload", CELL, "--seeds", "1"]) == 2
    assert limits._stats is limits_ties.stats
    assert limits.TIES == limits_ties.TIES


def test_gaps_all_groups_fit_the_reference_budget():
    """``gaps_all.py`` sends every finished request through the reference
    in consecutive groups, each within the token budget, none left out."""
    from perfbench import gaps_all

    class R:
        def __init__(self, p, o):
            self.prompt_len, self.out_tokens = p, [0] * o

    rs = [R(10, 5), R(20, 5), R(3, 1), R(30, 10), R(50, 5)]
    got = gaps_all.groups(rs, 40)
    assert [[r.prompt_len for r in g] for g in got] == [[10, 20], [3], [30],
                                                        [50]]
    assert sum(len(g) for g in got) == len(rs)
