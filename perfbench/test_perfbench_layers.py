"""Every per-layer reader on a synthetic traced run: it loads by its
metric's name, reads what it should, and reads nothing where nothing is
there."""

import numpy as np
import pytest

from perfbench import harness
from perfbench.conftest import model_json
from perfbench.driver import Iteration, Record
from perfbench.roofline import decode_attention as b1
from perfbench.roofline import model as roofline
from perfbench.roofline.peaks import PEAKS
from perfbench.tracing import breakdown, busy_in, union
from perfbench.traffic import Request

BENCH = harness.load_bench(harness.HERE.parent)
CFG = harness.load_config("grok1-2l")
PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def _run(n_b1=4, peaks=PEAK, cfg=CFG):
    r = Request(0, 0, 1.1, np.zeros(100, np.int32), 3)
    r.admitted, r.token_times = 1.2, [1.5, 1.6, 1.7]
    rec = Record(requests=[r], open=1.0, close=3.0)
    lens = np.array([99, 0, 10, 0])
    rec.iterations = [
        Iteration("mixed", 1.0, 1.05, [], (0, 100)),
        Iteration("solo", 1.05, 1.07, [101], None, lens),
        Iteration("solo", 1.07, 1.09, [102], None, lens + 1),
        Iteration("mixed", 1.09, 1.14, [103], (0, 100)),
        Iteration("solo", 1.14, 1.17, [104]),
    ]
    rec.traced = (1, 2)
    # microseconds: two solo iterations, B1 once per layer in each
    ev = {"ranges": [("solo", 0.0, 100.0), ("solo", 100.0, 200.0)],
          "kernels": sorted([("gemm", 0.0, 50.0), ("gemm", 100.0, 140.0)]
                            + [("void decode_kernel<bf16>", 60.0 + 10 * i,
                                65.0 + 10 * i) for i in range(n_b1)],
                            key=lambda k: k[1]),
          "host": [("aten::mm", 40.0, 120.0)]}
    return harness.Run(rec, cfg, {}, ev, peaks)


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["per_layer"]])
def test_every_reader_loads_and_reads(m):
    v = harness._reader(m, harness.HERE)(_run())
    assert isinstance(v, float) and np.isfinite(v), (m, v)


def test_readers_read_the_right_numbers():
    run = _run()
    read = lambda m: harness._reader(m, harness.HERE)(run)  # noqa: E731
    assert read("tau_mix_ms") == pytest.approx(50.0)
    assert read("tau_solo_ms") == pytest.approx(30.0)  # the untraced one
    assert read("queue_wait_p95_ms") == pytest.approx(100.0)
    assert read("device_idle_in_step") == pytest.approx(100 * (1 - 110 / 200))
    a = CFG["model"]["attn"]
    bound = 2 * sum(b1.bound_s(np.minimum(x + 1, 8192), a["n_heads"],
                               a["n_kv_heads"], a["head_dim"], 2, PEAK)
                    for x in (np.array([99, 0, 10, 0]),
                              np.array([100, 1, 11, 1])))
    assert read("b1_roofline") == pytest.approx(100 * bound / 20e-6)


def test_readers_read_nothing_where_nothing_is():
    assert harness._reader("b1_roofline", harness.HERE)(_run(n_b1=3)) \
        is None  # a B1 call missing from the trace
    assert harness._reader("mfu", harness.HERE)(_run(peaks=None)) is None


def test_trace_arithmetic():
    assert union([(0, 2), (1, 3), (5, 6)]) == 4
    assert busy_in([(0, 2), (1, 3), (5, 6)], [(1, 5)]) == 3
    out = breakdown(_run().events)
    assert out["device_ops"][0] == ["gemm", pytest.approx(90e-6)]
    gaps = dict(out["idle_gaps"])
    assert gaps == {"aten::mm": pytest.approx(30e-6)}


# grok1-2l's model FLOPs of four iterations, as the counting read before
# it learned latent attention, dense layers and held experts
GROK_ITERATIONS = [(([1, 100, 8191], None), 20792475648),
                   (([], (0, 512)), 2662456098816),
                   (([5, 6000], (1024, 300)), 1588121321472),
                   (([4096] * 63, (5632, 512)), 3244956647424)]


@pytest.mark.parametrize("its,want", GROK_ITERATIONS)
def test_grok_counts_what_it_counted(its, want):
    got = roofline.iteration_flops(CFG["model"], *its)
    assert type(got) is int and got == want


# Two layers of latent attention with 2 heads, the first dense, the second
# 2 held experts top-2 of a router over 8, with one shared expert.
MLA = {"n_layers": 2, "d_model": 16, "d_ff": 32, "vocab_size": 100,
       "pattern": ["mla"], "moe_start_layer": 1,
       "mla": {"n_heads": 2, "q_lora_rank": 8, "kv_lora_rank": 4,
               "qk_nope_dim": 4, "qk_rope_dim": 2, "v_head_dim": 4},
       "moe": {"n_experts": 2, "top_k": 2, "d_ff_expert": 8, "n_shared": 1,
               "router_experts": 8}}
# a layer's MLA projections: 2 (16·8 + 8·2·6 + 16·4 + 16·2 + 2·4·4
# + 2·4·4 + 2·4·16) = 1024; the dense layer's SwiGLU 6·16·32 = 3072; the
# MoE layer's router 2·16·8 = 256, shared expert 6·16·8 = 768, routed
# 2·2/8 of an expert = 384; a key 2·2·(4 + 2) + 2·2·4 = 40 a layer; a
# logit 2·16·100 = 3200
MLA_FIXED = 1024 + 3072 + 1024 + 256 + 768 + 384  # 6528
MLA_KEY = 2 * 40


def test_latent_attention_dense_layers_and_held_experts_by_hand():
    assert roofline.countable(MLA)
    assert roofline.token_flops(MLA, 10, True) == MLA_FIXED + 10 * MLA_KEY \
        + 3200
    assert roofline.token_flops(MLA, 10, False) == MLA_FIXED + 10 * MLA_KEY
    assert roofline.iteration_flops(MLA, [10], (3, 2)) == \
        (MLA_FIXED + 10 * MLA_KEY + 3200) \
        + (2 * MLA_FIXED + (4 + 5) * MLA_KEY + 3200)


def test_a_local_layer_attends_its_window():
    m = {"n_layers": 2, "d_model": 8, "d_ff": 16, "vocab_size": 10,
         "pattern": ["attn_local", "attn"],
         "attn": {"n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "window": 3}}
    fixed = 2 * (2 * 8 * (2 * 2 * 4 + 2 * 1 * 4) + 3 * 2 * 8 * 16)
    key, logit = 4 * 2 * 4, 2 * 8 * 10
    assert roofline.iteration_flops(m, [10], None) == \
        fixed + key * (3 + 10) + logit
    # positions 1..3 attend 2, 3, 4 keys: the local layer at most 3
    assert roofline.iteration_flops(m, [], (1, 3)) == \
        3 * fixed + key * ((2 + 3 + 3) + (2 + 3 + 4)) + logit


@pytest.mark.parametrize("arch,countable", [
    ("deepseek-v3-671b", True), ("qwen2-0.5b", True), ("gemma2-2b", True),
    ("mamba2-130m", False), ("recurrentgemma-2b", False),
    ("whisper-base", False), ("paligemma-3b", False)])
def test_mfu_reads_what_the_roofline_counts(arch, countable):
    from repro_torch.configs import get_config

    cfg = dict(CFG, model=model_json(get_config(arch, reduced=True)))
    assert roofline.countable(cfg["model"]) is countable
    v = harness._reader("mfu", harness.HERE)(_run(cfg=cfg))
    assert (v is not None and np.isfinite(v) and v > 0) is countable
    assert (v is None) is not countable
