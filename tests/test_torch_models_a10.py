"""The rest of the port's data plane held to the JAX package on the CPU:
the reference's weights carried across leaf for leaf, the
capacity-dispatch MoE alone, the serving steps with the stub inputs,
the decode step's masked merge over MLA latents and cross-attention K/V,
and the engine's refusal of an encoder-decoder without frames (ROADMAP
C-ref7).

The whole-model parity of paligemma-3b, whisper-base, deepseek-v3-671b
and grok-1-314b (prefill, continuation chunks, decodes, bf16, int8
latents) is in ``tests/test_torch_models.py``.  Tolerances are that
file's: f32 1e-5 relative to the largest magnitude; greedy tokens and
integer leaves exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.types import ServicePrimitives as RefPrim
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.serving import steps as RS
from repro.serving.engine import ServerEngine as RefEngine
from repro.serving.engine import SlotRequest as RefRequest
from repro_torch.configs import get_config
from repro_torch.core.types import ServicePrimitives
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.params import _walk, params_from_numpy, tree_map
from repro_torch.serving import steps as TS
from repro_torch.serving.engine import ServerEngine, SlotRequest
from test_torch_gpu import _stubs

REL = 1e-5
MOE_ARCHS = ["grok-1-314b", "deepseek-v3-671b"]
# arch -> parameter subtrees its reduced config must carry across
A10_LEAVES = {
    "paligemma-3b": [("seg0", "b0", "attn", "wq")],
    "whisper-base": [("pos_embed",), ("encoder", "pos"),
                     ("encoder", "layers", "attn", "wq"),
                     ("encoder", "final_norm", "scale"),
                     ("seg0", "b0", "xattn", "wk"),
                     ("seg0", "b0", "lnx", "bias")],
    "deepseek-v3-671b": [("seg0", "b0", "mla", "w_uk"),
                         ("seg0", "b1", "moe", "router"),
                         ("seg0", "b1", "moe", "shared", "w_down"),
                         ("mtp", "proj"), ("mtp", "norm", "scale")],
    "grok-1-314b": [("seg0", "b0", "moe", "w_gate")],
}


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rel,
                               atol=rel * scale)


def _mk(arch, **over):
    ref_cfg = ref_get_config(arch, reduced=True).replace(**over)
    cfg = get_config(arch, reduced=True).replace(**over)
    rp = jax.tree.map(np.asarray, RM.init_model(ref_cfg,
                                                jax.random.PRNGKey(1)))
    return ref_cfg, cfg, rp, params_from_numpy(rp, "cpu")


@pytest.mark.parametrize("arch", list(A10_LEAVES))
def test_params_from_numpy_loads_the_reference_tree_leaf_for_leaf(arch):
    """The reference's numpy tree of every reduced config carries across
    whole: the port's ``model_defs`` leaves, shapes and values, MLA, MoE
    with shared experts, the encoder, cross-attention, learned positions
    and deepseek's MTP head (off the serving path) included."""
    _, cfg, rp, tp = _mk(arch)
    want = dict(_walk(TM.model_defs(cfg)))
    got = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                got[path + (k,)] = v
    walk(tp)
    assert set(got) == set(want)
    assert set(A10_LEAVES[arch]) <= set(got)
    for path, d in want.items():
        ref = rp
        for k in path:
            ref = ref[k]
        assert tuple(got[path].shape) == tuple(d.shape) == ref.shape, path
        assert got[path].dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].numpy(), ref)


def _moe_params(cfg, seed):
    """A MoE layer's weights as numpy: the reference's init rules, with a
    router wide enough (std 1) to make some experts popular."""
    tree = jax.tree.map(np.asarray, RM.init_params(
        RMoE.moe_defs(cfg.moe, cfg.d_model), jax.random.PRNGKey(seed)))
    tree["router"] = tree["router"] * 50.0
    return tree


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
def test_apply_moe_matches_reference_with_capacity_drops(arch,
                                                         capacity_factor):
    """Softmax top-k, renormalised gates, capacity dispatch and the
    combine, at a capacity factor that drops copies (0.25) and at the
    configs' (1.25).  The same copies are dropped as in the reference, so
    the outputs agree to summation order; a token with every copy
    dropped gets the shared experts' output alone (zero for grok-1)."""
    cfg = get_config(arch, reduced=True)
    moe = cfg.moe.__class__(**{**cfg.moe.__dict__,
                               "capacity_factor": capacity_factor})
    ref_cls = ref_get_config(arch, reduced=True).moe.__class__
    ref_moe = ref_cls(**{k: v for k, v in moe.__dict__.items()
                         if k in ref_cls.__dataclass_fields__})
    tree = _moe_params(cfg, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    want = np.asarray(RMoE.apply_moe(ref_moe, tree, jnp.asarray(x)))
    p = params_from_numpy(tree, "cpu")
    got = TMoE.apply_moe(moe, p, torch.from_numpy(x))
    _close(got, want)

    # the copies each expert received, in token order (a stable sort)
    T, k, E = 96, moe.top_k, moe.n_experts
    logits = torch.from_numpy(x).reshape(T, -1) @ p["router"]
    idx = torch.topk(torch.softmax(logits, -1), k, dim=-1).indices
    cap = TMoE._capacity(moe, T)
    seen = {e: 0 for e in range(E)}
    kept = np.zeros(T, bool)
    for t in range(T):
        for e in idx[t].tolist():
            kept[t] |= seen[e] < cap
            seen[e] += 1
    dropped = sum(max(0, n - cap) for n in seen.values())
    if capacity_factor < 1:
        assert dropped > 0 and not kept.all()
        lost = ~kept
        xt = torch.from_numpy(x).reshape(T, -1)[lost]
        if moe.n_shared:
            sp = p["shared"]
            alone = (torch.nn.functional.silu(xt @ sp["w_gate"])
                     * (xt @ sp["w_up"])) @ sp["w_down"]
        else:
            alone = torch.zeros_like(xt)
        torch.testing.assert_close(got.reshape(T, -1)[lost], alone,
                                   rtol=REL, atol=REL)
    else:
        assert dropped == 0


def _server_state(pkg, cfg, B, max_len):
    if pkg == "ref":
        return RS.init_server_state(cfg, B, max_len, jnp.float32)
    return TS.init_server_state(cfg, B, max_len, torch.float32, "cpu")


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-base"])
def test_mixed_step_with_stubs_matches_reference(arch):
    """``make_mixed_step`` with ``prefix_embeds`` (paligemma, the prefix
    prepended to the chunk) and with ``enc_frames`` (whisper, the
    encoder's K/V into the slot's cross-attention cache), after a
    whole-batch ``make_prefill_step`` with the same stubs: the decode
    tokens, the chunk's token and every cache leaf as the reference's."""
    ref_cfg, cfg, rp, tp = _mk(arch)
    B, max_len, C, S = 3, 96, 16, 24
    rng = np.random.default_rng(5)
    toks = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    chunk = rng.integers(2, cfg.vocab_size, C).astype(np.int32)
    st_b = _stubs(cfg, B, rng)
    # the chunk's slot takes one request's stubs
    st_1 = {k: v[1:2] if k == "enc_frames" else v[:1]
            for k, v in st_b.items()}
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    out = {}
    for pkg, c, params, to, mods in (
            ("ref", ref_cfg, rp, jnp.asarray, RS),
            ("port", cfg, tp, torch.from_numpy, TS)):
        st = _server_state(pkg, c, B, max_len)
        caches, nxt = mods.make_prefill_step(c)(
            params, st["caches"], to(toks), to(pos),
            **{k: to(v) for k, v in st_b.items()})
        length = np.full((B,), S, np.int32)
        state = dict(st, caches=caches, length=to(length), last_token=nxt,
                     active=to(np.array([True, False, True])))
        # the chunk's end, which the port's step takes and the reference's
        # does not
        end = {"kv_len": C} if pkg == "port" else {}
        res = mods.make_mixed_step(c, C)(
            params, state, 1, to(chunk), to(np.zeros((1, 1), np.int32)),
            **{k: to(v) for k, v in st_1.items()}, **end)
        out[pkg] = (nxt, res)
    (w_nxt, (w_state, w_dec, w_tok)), (g_nxt, (g_state, g_dec, g_tok)) = \
        out["ref"], out["port"]
    np.testing.assert_array_equal(g_nxt.numpy(), np.asarray(w_nxt))
    np.testing.assert_array_equal(g_dec.numpy(), np.asarray(w_dec))
    assert int(g_tok) == int(w_tok)
    for k in ("length", "last_token", "active"):
        np.testing.assert_array_equal(g_state[k].numpy(),
                                      np.asarray(w_state[k]))
    flat = jax.tree_util.tree_leaves_with_path(w_state["caches"])
    assert len(flat) == len(jax.tree.leaves(g_state["caches"]))
    for path, w in flat:
        g = g_state["caches"]
        for key in path:
            g = g[key.idx if hasattr(key, "idx") else key.key]
        if w.dtype == jnp.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


@pytest.mark.parametrize("arch,kv_quant", [
    ("deepseek-v3-671b", False), ("deepseek-v3-671b", True),
    ("whisper-base", False)])
def test_decode_step_leaves_inactive_slots_alone(arch, kv_quant):
    """The decode step's masked merge over MLA latents (and their int8
    values and scales) and cross-attention K/V: inactive slots keep every
    leaf bit for bit, active slots take the decode's writes."""
    _, cfg, _, tp = _mk(arch, kv_quant=kv_quant)
    B, S = 3, 20
    rng = np.random.default_rng(6)
    st = TS.init_server_state(cfg, B, 64, torch.float32, "cpu")
    kw = {k: torch.from_numpy(v) for k, v in _stubs(cfg, B, rng).items()}
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S)).astype(
        np.int32))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    caches, nxt = TS.make_prefill_step(cfg)(tp, st["caches"], toks, pos,
                                            **kw)
    state = dict(st, caches=caches, length=torch.full((B,), S,
                                                      dtype=torch.int32),
                 last_token=nxt, active=torch.tensor([True, False, True]))
    # the step writes the caches it is given: it gets a copy
    new, _ = TS.make_decode_step(cfg)(tp, tree_map(torch.clone, state))
    names = set()
    for seg_new, seg_old in zip(new["caches"], caches):
        for blk, old in zip(seg_new.values(), seg_old.values()):
            for n, a in blk.items():
                names.add(n)
                assert torch.equal(a[:, 1], old[n][:, 1]), n
                if n in ("xk", "xv"):  # read, never written, by a decode
                    assert torch.equal(a, old[n]), n
                else:
                    assert not torch.equal(a[:, 0], old[n][:, 0]), n
    want = ({"xk", "xv", "k", "v", "pos"} if cfg.encoder is not None else
            {"c_kv", "k_rope"} | ({"c_s", "r_s"} if kv_quant else set()))
    assert names == want
    assert new["length"].tolist() == [S + 1, S, S + 1]


def _whisper_engine(Engine, Prim, Request, cfg, params, **kw):
    eng = Engine(cfg, params, prim=Prim(batch_cap=2, chunk=8), max_len=64,
                 **kw)
    eng.start_prefill(Request(rid=0, cls=0, prompt_len=12, decode_len=4),
                      np.arange(2, 14, dtype=np.int32))
    return eng


@pytest.mark.xfail(strict=True, raises=AttributeError, reason=(
    "ROADMAP C-ref7: the reference's engine never passes enc_frames to "
    "its mixed step, so the encoder runs on None and its serve cannot "
    "serve whisper-base"))
def test_c_ref7_reference_engine_serves_whisper():
    ref_cfg, _, rp, _ = _mk("whisper-base")
    _whisper_engine(RefEngine, RefPrim, RefRequest, ref_cfg, rp).step()


def test_c_ref7_port_engine_refuses_whisper_naming_enc_frames():
    """The port keeps the reference's engine, which has no frame source:
    its first iteration refuses the encoder-decoder with an error that
    names the missing input, and invents no frames."""
    _, cfg, _, tp = _mk("whisper-base")
    eng = _whisper_engine(ServerEngine, ServicePrimitives, SlotRequest, cfg,
                          tp, device="cpu")
    with pytest.raises(ValueError, match="needs enc_frames"):
        eng.step()
