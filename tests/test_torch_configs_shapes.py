"""The port's shape registry, HLO-line parser and roofline held to the
reference's (``tests/test_configs_shapes.py``'s cases on the port).

``input_specs`` gives meta tensors where the reference gives
``jax.ShapeDtypeStruct``: the same shapes and dtypes, held cell by cell.
``collective_traffic`` and ``roofline_terms`` are held bitwise on the
reference test's inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.configs import skip_reason as ref_skip_reason
from repro.launch.hlo_analysis import collective_traffic as ref_traffic
from repro.launch.roofline import roofline_terms as ref_roofline_terms
from repro_torch.configs import (ARCHS, SHAPES, all_cells, get_config,
                                 input_specs, skip_reason, supported_shapes)
from repro_torch.launch.hlo_analysis import collective_traffic
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import hw_constants, roofline_terms
from repro_torch.models.config import segment_layers

PARSER_TEXT = """
  %ag = bf16[32,64]{1,0} all-gather(%p), replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[128,128]{1,0} reduce-scatter(%q), replica_groups=[2,8]<=[16], to_apply=%add
  %cp = f32[4,4]{1,0} collective-permute(%r), source_target_pairs={{0,1},{1,0}}
  %noop = f32[4,4]{1,0} collective-permute(%r), source_target_pairs={}
"""

ROOFLINE_RECORD = {
    "extrapolated": {"flops": 197e12 * 0.5, "bytes": 819e9 * 2.0,
                     "coll_total": 50e9 * 0.25},
    "n_devices": 256,
    "model_flops": 197e12 * 0.25 * 256,
    "memory": {"argument_bytes": 819e9 * 1.0},
}


def test_registry_complete():
    assert list(ARCHS) == list(REF_ARCHS)
    assert len(ARCHS) == 10
    assert len(SHAPES) == 4
    assert len(all_cells()) == 40


def test_exact_published_configs():
    spec = {
        "whisper-base": (6, 512, 2048, 51865),
        "deepseek-v3-671b": (61, 7168, 18432, 129280),
        "grok-1-314b": (64, 6144, 32768, 131072),
        "deepseek-67b": (95, 8192, 22016, 102400),
        "qwen2-0.5b": (24, 896, 4864, 151936),
        "gemma2-2b": (26, 2304, 9216, 256000),
        "phi4-mini-3.8b": (32, 3072, 8192, 200064),
        "recurrentgemma-2b": (26, 2560, 7680, 256000),
        "mamba2-130m": (24, 768, 0, 50280),
        "paligemma-3b": (18, 2048, 16384, 257216),
    }
    for arch, (L, d, ff, V) in spec.items():
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
            L, d, ff, V), arch
    assert get_config("deepseek-v3-671b").mla.n_heads == 128
    assert get_config("deepseek-v3-671b").moe.n_experts == 256
    assert get_config("deepseek-v3-671b").moe.top_k == 8
    assert get_config("grok-1-314b").attn.n_kv_heads == 8
    assert get_config("grok-1-314b").moe.top_k == 2
    assert get_config("qwen2-0.5b").attn.qkv_bias
    assert get_config("gemma2-2b").logit_softcap == 30.0
    assert get_config("recurrentgemma-2b").pattern == ("rec", "rec",
                                                       "attn_local")
    assert get_config("mamba2-130m").ssm.d_state == 128
    assert get_config("paligemma-3b").vision.n_patches == 256


def test_long_500k_skip_rules():
    """long_500k runs for SSM/hybrid/local-global, skips pure full-attn,
    with the reference's reason word for word."""
    runs = {a for a in ARCHS
            if skip_reason(get_config(a), "long_500k") is None}
    assert runs == {"mamba2-130m", "recurrentgemma-2b", "gemma2-2b"}
    for a in ARCHS:
        for s in SHAPES:
            assert skip_reason(get_config(a), s) == ref_skip_reason(
                ref_get_config(a), s), (a, s)


@pytest.mark.parametrize("reduced", [False, True])
def test_input_specs_match_the_reference(reduced):
    dtypes = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=reduced)
        ref_cfg = ref_get_config(arch, reduced=reduced)
        for s in supported_shapes(cfg):
            got = input_specs(cfg, s)
            want = ref_input_specs(ref_cfg, s)
            assert list(got) == list(want), (arch, s)
            for k, w in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == w.shape, (arch, s, k)
                assert got[k].dtype == dtypes[w.dtype.type], (arch, s, k)
            sh = SHAPES[s]
            assert got["tokens"].shape[0] == sh.global_batch
            if sh.kind == "decode":
                assert tuple(got["tokens"].shape) == (sh.global_batch, 1)
            else:
                assert got["tokens"].shape[1] == sh.seq_len
                assert ("enc_frames" in got) == (cfg.encoder is not None)
                assert ("prefix_embeds" in got) == (cfg.vision is not None)
        assert input_specs(cfg, "train_4k", global_batch=8)[
            "tokens"].shape[0] == 8


def test_segment_compression():
    """Layer patterns compress into few segments."""
    for arch in ARCHS:
        cfg = get_config(arch)
        segs = segment_layers(cfg.block_specs())
        assert sum(len(b) * r for b, r in segs) == cfg.n_layers
        assert len(segs) <= 3, (arch, len(segs))


def test_make_production_mesh_shapes():
    """The port's meshes hold shapes only, so both production meshes build
    on any host (the reference's need 256 / 512 devices)."""
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 16, "model": 16}


def test_collective_parser_bitwise():
    out = collective_traffic(PARSER_TEXT)
    assert out == ref_traffic(PARSER_TEXT)
    assert out["all-gather"] == pytest.approx(15 / 16 * 32 * 64 * 2)
    assert out["reduce-scatter"] == pytest.approx(7 / 8 * 128 * 128 * 4)
    assert out["collective-permute"] == pytest.approx(4 * 4 * 4)
    assert out["counts"]["all-gather"] == 1


def test_roofline_terms_bitwise():
    t = roofline_terms(ROOFLINE_RECORD)
    assert t == ref_roofline_terms(ROOFLINE_RECORD)
    assert roofline_terms(ROOFLINE_RECORD, hw_constants("v5e")) == t
    assert t["compute_s"] == pytest.approx(0.5)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.25)
    assert t["dominant"] == "memory"
    assert t["roofline_fraction"] == pytest.approx(0.5)


def test_roofline_at_the_card():
    """The H100 SXM's table: data-sheet rates, NVLink's 900 GB/s over 18
    links both ways as 25 GB/s a link one way; no TPU figure."""
    hw = hw_constants("h100")
    assert hw == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                  "ici_link_bw": 25e9}
    t = roofline_terms(ROOFLINE_RECORD, hw)
    ex = ROOFLINE_RECORD["extrapolated"]
    assert t["compute_s"] == ex["flops"] / 989e12
    assert t["collective_s"] == ex["coll_total"] / 25e9
    assert np.isclose(t["t_ideal_s"], max(0.25 * 197 / 989, 819 / 3350))
