"""The port's attention-bearing models held to the JAX package on the CPU.

Reduced qwen2-0.5b, gemma2-2b (local ring + global layers, softcaps),
phi4-mini-3.8b and recurrentgemma-2b (RG-LRU + local attention), and the
four archs of the rest of the data plane: paligemma-3b (prefix-LM over
stub patch embeddings), whisper-base (encoder, cross-attention, learned
positions), deepseek-v3-671b (MLA, dense then MoE layers with a shared
expert) and grok-1-314b (MoE), through ``forward_prefill``/
``forward_decode`` of both packages on the same weights (carried across
by ``params_from_numpy``) and the same tokens and stubs, numpy draws
from fixed seeds.  Prompts run past the reduced windows (32) so the
local layers' rings wrap.  On the CPU decode attention runs B1's plain
version and ``kernel_impl="pallas"`` B2's.

Tolerances, relative to the largest magnitude:

* f32: 1e-5 on logits and caches (summation order only); positions
  bitwise.
* ``param_dtype="bfloat16"`` with f32 caches: 5e-2 (``tests/
  test_torch_ssm.py``'s model tolerance), against the reference run with
  ``unroll=True``, the form whose semantics the port keeps (ROADMAP
  C-ref5: the scanned form refuses the residual's change of dtype).
"""

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models.params import params_from_numpy, tree_map
from test_torch_gpu import _stubs

ARCHS = ["qwen2-0.5b", "gemma2-2b", "phi4-mini-3.8b", "recurrentgemma-2b",
         "paligemma-3b", "whisper-base", "deepseek-v3-671b", "grok-1-314b"]
REL = {"float32": 1e-5, "bfloat16": 5e-2}
B, MAX_LEN = 2, 96


def _close(got, want, rel):
    """|got - want| <= rel x (|want| + max |want|)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _model(arch, param_dtype="float32", attn=None, **over):
    """``attn``: fields of the attention config to change, in both."""
    cfgs = []
    for get in (ref_get_config, get_config):
        c = get(arch, reduced=True)
        if attn:
            c = c.replace(attn=dataclasses.replace(c.attn, **attn))
        cfgs.append(c.replace(param_dtype=param_dtype, **over))
    ref_cfg, cfg = cfgs
    rp = jax.tree.map(np.asarray, RM.init_model(ref_cfg,
                                                jax.random.PRNGKey(1)))
    return ref_cfg, cfg, rp, params_from_numpy(rp, "cpu")


def _caches_close(got, want, rel):
    """Every leaf in the reference's dtype: integer leaves equal, f16
    scales to 2e-3, f32 leaves within ``rel``, bf16 leaves within the bf16
    tolerance."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.idx if hasattr(k, "idx") else k.key]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        if w.dtype in (jnp.int32, jnp.int8):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        elif w.dtype == jnp.float16:  # int8 caches' scales
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32), rtol=2e-3)
        elif w.dtype == jnp.bfloat16:
            _close(g, w, REL["bfloat16"])
        else:
            _close(g, w, rel)


@lru_cache(maxsize=None)
def _ref_jit(fn, ref_cfg, unroll, kw):
    """The reference's ``fn``, jitted once per config and keyword set
    (the tests share its compilations)."""
    return jax.jit(partial(fn, ref_cfg, unroll=unroll, **dict(kw)))


class _Pair:
    """The same model in both packages, stepped together.  Every prefill
    takes the config's stubs (the prefix on every chunk, as the mixed
    step prepends it); decodes run at text positions shifted past the
    prefix."""

    def __init__(self, arch, param_dtype="float32", unroll=False,
                 cache_dtype="float32", **over):
        self.ref_cfg, self.cfg, self.rp, self.tp = _model(arch, param_dtype,
                                                          **over)
        self.rc = RM.init_cache(self.ref_cfg, B, MAX_LEN,
                                jnp.dtype(cache_dtype))
        self.tc = TM.init_cache(self.cfg, B, MAX_LEN,
                                getattr(torch, cache_dtype), "cpu")
        self.unroll = unroll
        self.rng = np.random.default_rng(8)
        self.stubs = _stubs(self.cfg, B, self.rng)
        self.P = self.cfg.vision.n_patches if self.cfg.vision else 0

    def _ref(self, fn, **kw):
        return _ref_jit(fn, self.ref_cfg, self.unroll,
                        tuple(sorted(kw.items())))

    def prefill(self, S, pos0=0, kv_len=None, **kw):
        """``kv_len`` goes to the port alone: the reference has no such
        argument and reads the whole cache."""
        toks = self.rng.integers(0, self.cfg.vocab_size, (B, S)).astype(
            np.int32)
        pos = np.broadcast_to(np.arange(pos0, pos0 + S)[None], (B, S)
                              ).astype(np.int32)
        want, self.rc = self._ref(RM.forward_prefill, **kw)(
            self.rp, jnp.asarray(toks), jnp.asarray(pos), self.rc,
            **{k: jnp.asarray(v) for k, v in self.stubs.items()})
        got, self.tc = TM.forward_prefill(
            self.cfg, self.tp, torch.from_numpy(toks), torch.from_numpy(pos),
            self.tc, **{k: torch.from_numpy(v) for k, v in self.stubs.items()},
            kv_len=kv_len, **kw)
        return got, want

    def decode(self, pos):
        toks = self.rng.integers(0, self.cfg.vocab_size, (B, 1)).astype(
            np.int32)
        p = np.full((B,), self.P + pos, np.int32)
        want, self.rc = self._ref(RM.forward_decode)(
            self.rp, jnp.asarray(toks), jnp.asarray(p), self.rc)
        got, self.tc = TM.forward_decode(
            self.cfg, self.tp, torch.from_numpy(toks), torch.from_numpy(p),
            self.tc)
        return got, want


def _prefill_then_decode(pair, rel, S=40, steps=6):
    got, want = pair.prefill(S)
    assert got.shape == (B, 1, pair.cfg.vocab_size)
    _close(got, want, rel)
    for i in range(steps):
        got, want = pair.decode(S + i)
        _close(got, want, rel)
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_f32(arch):
    pair = _Pair(arch)
    _prefill_then_decode(pair, REL["float32"])
    _caches_close(pair.tc, pair.rc, REL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unrolled_reference_bf16(arch):
    """bf16 activations against f32 caches: the first attention or MLA
    layer that reads its cache (decode; deepseek's MLA prefill does not)
    promotes the residual stream to f32, as the reference's unrolled form
    does."""
    pair = _Pair(arch, "bfloat16", unroll=True)
    got, want = _prefill_then_decode(pair, REL["bfloat16"], steps=3)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_continuation_matches_reference(arch):
    """A 40-token prefill, then two 16-token continuation chunks (the
    engine's mixed step) over the wrapped rings, then decode."""
    pair = _Pair(arch)
    _close(*pair.prefill(40), REL["float32"])
    for pos0 in (40, 56):
        _close(*pair.prefill(16, pos0, kv_len=pos0 + 16, continuation=True),
               REL["float32"])
    for i in range(2):
        _close(*pair.decode(72 + i), REL["float32"])
    _caches_close(pair.tc, pair.rc, REL["float32"])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-2b", "paligemma-3b",
                                  "whisper-base", "grok-1-314b"])
def test_prefill_pallas_matches_reference(arch):
    """``kernel_impl="pallas"``: B2's plain version on the port's side,
    the reference's Pallas kernel (interpret mode) on the other;
    paligemma's with its prefix-LM mask over the stub patches."""
    pair = _Pair(arch)
    got, want = pair.prefill(40, kernel_impl="pallas")
    _close(got, want, REL["float32"])
    _caches_close(pair.tc, pair.rc, REL["float32"])
    _close(*pair.decode(40), REL["float32"])


def _c_ref5_example(unroll):
    """qwen2 at bf16 params, f32 caches: a continuation chunk and a
    decode step, the engine's two iterations."""
    pair = _Pair("qwen2-0.5b", "bfloat16", unroll=unroll)
    pair.prefill(16)
    _close(*pair.prefill(16, 16, kv_len=32, continuation=True),
           REL["bfloat16"])
    _close(*pair.decode(32), REL["bfloat16"])


@pytest.mark.xfail(strict=True, raises=TypeError, reason=(
    "ROADMAP C-ref5: the reference's scanned layer loop refuses bf16 "
    "activations against f32 caches (the carry turns f32 after the first "
    "attention layer), so its RealCluster cannot serve a bf16 attention "
    "model"))
def test_c_ref5_scanned_reference_serves_bf16_params_with_f32_caches():
    _c_ref5_example(unroll=False)


def test_c_ref5_port_matches_the_unrolled_reference():
    _c_ref5_example(unroll=True)


def test_mla_int8_latents_match_reference():
    """deepseek-v3 with ``kv_quant``: int8 latents and RoPE keys with f16
    per-token scales, through a whole prefill, two continuation chunks
    and decodes; the int8 values equal, the scales equal to f16."""
    pair = _Pair("deepseek-v3-671b", kv_quant=True)
    _close(*pair.prefill(40), REL["float32"])
    for pos0 in (40, 56):
        _close(*pair.prefill(16, pos0, continuation=True), REL["float32"])
    for i in range(3):
        _close(*pair.decode(72 + i), REL["float32"])
    leaves = pair.tc[0]["b0"]
    assert leaves["c_kv"].dtype == torch.int8
    assert leaves["c_s"].dtype == torch.float16
    _caches_close(pair.tc, pair.rc, REL["float32"])


@pytest.mark.parametrize("over", [{}, {"kv_quant": True}],
                         ids=["latents", "int8-latents"])
def test_mla_chunks_cut_at_kv_len_match_reference(over):
    """deepseek-v3's continuation chunks given ``kv_len``, the chunk's end
    as the engine gives it: the latent attention reads only the cache's
    first ``kv_len`` slots of 96, and the logits and caches still match
    the reference's chunks over the whole cache."""
    pair = _Pair("deepseek-v3-671b", **over)
    _close(*pair.prefill(40), REL["float32"])
    for pos0 in (40, 56):
        _close(*pair.prefill(16, pos0, kv_len=pos0 + 16, continuation=True),
               REL["float32"])
    for i in range(2):
        _close(*pair.decode(72 + i), REL["float32"])
    _caches_close(pair.tc, pair.rc, REL["float32"])


# reduced configs whose attention differs from the reduced arch's: grok-1's
# softcap 30 and 6 query heads to a KV head, as the full model has them
ATTN_CHUNKS = {"grok-1-314b": {"n_heads": 12, "n_kv_heads": 2,
                               "attn_softcap": 30.0},
               "qwen2-0.5b": None}


@pytest.mark.parametrize("arch", list(ATTN_CHUNKS))
def test_attention_chunks_cut_at_kv_len_match_reference(arch, monkeypatch):
    """Continuation chunks of attention models given ``kv_len``, the
    chunk's end as the engine gives it: over the plain cache each chunk
    runs through B2 (its plain version here) over the cache's first
    ``kv_len`` slots of 96, and the logits and caches match the
    reference's blockwise chunks over the whole cache."""
    from repro_torch.models import attention as TA

    seen = []
    b2 = TA.pf_ops.prefill_attention

    def spy(q, k, v, **kw):
        seen.append((int(kw["q_offset"][0]), k.shape[1]))
        return b2(q, k, v, **kw)

    monkeypatch.setattr(TA.pf_ops, "prefill_attention", spy)
    pair = _Pair(arch, attn=ATTN_CHUNKS[arch])
    _close(*pair.prefill(40), REL["float32"])
    chunks = ((40, 16), (56, 16), (72, 8))
    for pos0, n in chunks:
        _close(*pair.prefill(n, pos0, kv_len=pos0 + n, continuation=True),
               REL["float32"])
    layers = pair.cfg.n_layers
    assert seen == [(pos0, pos0 + n) for pos0, n in chunks for _ in
                    range(layers)]
    for i in range(2):
        _close(*pair.decode(80 + i), REL["float32"])
    _caches_close(pair.tc, pair.rc, REL["float32"])


def test_mla_chunk_reads_no_key_past_kv_len():
    """What lies in the latent cache at or past ``kv_len`` does not reach
    the chunk: NaN written there leaves its logits as a clean cache gives
    them, where the chunk over the whole cache reads NaN."""
    cfg = get_config("deepseek-v3-671b", reduced=True)
    params = TM.init_model(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(4))
    pos = torch.arange(24)[None]
    caches = TM.init_cache(cfg, 1, 64, torch.float32, "cpu")
    _, caches = TM.forward_prefill(cfg, params, toks[:, :16], pos[:, :16],
                                   caches)

    def chunk(junk, kv_len):
        c = tree_map(torch.clone, caches)
        for seg in c:
            for leaves in seg.values():
                for a in leaves.values():
                    a[:, :, 24:] = junk
        return TM.forward_prefill(cfg, params, toks[:, 16:], pos[:, 16:], c,
                                  continuation=True, kv_len=kv_len)[0]

    clean = chunk(0.0, None)
    assert torch.equal(chunk(float("nan"), 24), chunk(0.0, 24))
    torch.testing.assert_close(chunk(float("nan"), 24), clean, rtol=1e-5,
                               atol=1e-5)
    assert torch.isnan(chunk(float("nan"), None)).all()


def test_whisper_bf16_caches_keep_cross_attention_kv_in_f32():
    """whisper-base's f32 weights over bf16 caches: the self-attention
    K/V round to the cache's bf16, the cross-attention K/V stay in the
    activations' f32, as the reference's cache tree holds them, through
    a whole prefill, two continuation chunks and decodes.  The decodes'
    logits are held to the bf16 tolerance: the reference rounds the
    softmax weights to the cache's bf16 before P.V, B1 keeps them f32."""
    pair = _Pair("whisper-base", cache_dtype="bfloat16")
    _close(*pair.prefill(40), REL["float32"])
    for pos0 in (40, 56):
        _close(*pair.prefill(16, pos0, kv_len=pos0 + 16, continuation=True),
               REL["float32"])
    leaves = pair.tc[0]["b0"]
    assert leaves["k"].dtype == torch.bfloat16
    assert leaves["xk"].dtype == leaves["xv"].dtype == torch.float32
    _caches_close(pair.tc, pair.rc, REL["float32"])
    for i in range(3):
        _close(*pair.decode(72 + i), REL["bfloat16"])
    _caches_close(pair.tc, pair.rc, REL["bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_leaves_its_input_caches_as_they_were(arch):
    """The entry points write the caches they are given where those lie
    and hand back the same tensors (f32 caches under f32 activations: no
    leaf changes dtype); a caller who wants its caches kept copies them
    first (``tree_map(torch.clone, ...)``), and the copy stays apart."""
    cfg = get_config(arch, reduced=True)
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    caches = TM.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 40)).astype(
        np.int32))
    pos = torch.arange(40, dtype=torch.int32)[None].expand(B, 40)
    kw = {k: torch.from_numpy(v) for k, v in _stubs(cfg, B, rng).items()}
    _, caches = TM.forward_prefill(cfg, params, toks, pos, caches, **kw)
    for call in ("prefill", "decode"):
        kept = tree_map(torch.clone, caches)
        if call == "prefill":
            _, out = TM.forward_prefill(cfg, params, toks[:, :16], pos[:, :16]
                                        + 40, caches, continuation=True,
                                        kv_len=56, **kw)
        else:
            _, out = TM.forward_decode(cfg, params, toks[:, :1],
                                       torch.full((B,), 56, dtype=torch.int32),
                                       caches)
        for seg, seg_kept, seg_out in zip(caches, kept, out):
            for k, c in seg.items():
                for n, a in c.items():
                    o = seg_out[k][n]
                    assert o is a, (call, k, n)
                    assert o.untyped_storage().data_ptr() \
                        != seg_kept[k][n].untyped_storage().data_ptr()
        assert any(not torch.equal(a, seg_kept[k][n])
                   for seg, seg_kept in zip(out, kept)
                   for k, c in seg.items() for n, a in c.items())
