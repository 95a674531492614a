"""The port's SSM path held to the JAX package on the CPU.

On the CPU ``ssd_scan`` runs its plain PyTorch version (the CUDA kernel's
arithmetic, looped over chunks in f32); it is held to the reference's
oracle ``ssd_scan_ref`` and to its Pallas kernel in interpret mode, at the
shapes of ``tests/test_kernels.py``.  ``ssm_forward``/``ssm_decode`` and
the reduced mamba2 ``forward_prefill``/``forward_decode`` are held to
``repro.models`` on the same weights, carried across by
``params_from_numpy``.  Inputs are numpy draws from fixed seeds.

Tolerances:

* scan, f32: y 2e-4 and state 1e-2, those of ``tests/test_kernels.py``.
* scan, bf16: both sides compute in f32 from the same bf16 inputs and
  round y once, so one bf16 rounding step, 2**-7 of the value, on top of
  the f32 2e-4.
* SSM layer and model, f32: 1e-5 relative to the largest magnitude
  (summation order only).
* SSM layer and model, bf16: 5e-2 relative to the largest magnitude (the
  reference's bf16 kernel tolerance): the port's scan rounds y once where
  the reference's loop rounds ``w`` and ``y_inter`` to bf16 as well, and
  the two frameworks round bf16 elementwise chains at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ops import ssd_scan as ref_ssd_ops
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models import model as RM
from repro.models import ssm as RS
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.params import params_from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _scan_inputs(B, S, H, P, N, dtype, seed=3):
    """The distribution of ``tests/test_kernels.py``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    la = (-0.1 * np.abs(rng.standard_normal((B, S, H)))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jax_in = [jnp.asarray(a, jdt) for a in (x, Bm, Cm)] + [jnp.asarray(la)]
    torch_in = [torch.from_numpy(a).to(tdt) for a in (x, Bm, Cm)] \
        + [torch.from_numpy(la)]
    return jax_in, torch_in


def _scan_close(y, h, yr, hr, dtype):
    y_rtol = 2e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               atol=2e-4, rtol=y_rtol)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-2,
                               rtol=1e-2)


def _close(got, want, rel):
    """|got - want| <= rel x (|want| + max |want|)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


REL = {"float32": 1e-5, "bfloat16": 5e-2}

SCAN_SHAPES = [(1, 128, 2, 16, 16, 32), (2, 256, 3, 16, 32, 64),
               (1, 512, 4, 32, 64, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_plain_matches_pallas_interpret_and_ref(B, S, H, P, N, chunk,
                                                    dtype):
    (jx, jB, jC, jla), (x, Bm, Cm, la) = _scan_inputs(B, S, H, P, N, dtype)
    n = ssd_scan.launches
    y, h = ssd_scan(x, Bm, Cm, la)
    assert ssd_scan.launches == n  # the CPU runs the plain version
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    _scan_close(y, h, *ssd_scan_pallas(jx, jB, jC, jla, chunk=chunk,
                                       interpret=True), dtype)
    _scan_close(y, h, *ssd_scan_ref(jx, jB, jC, jla), dtype)
    # the plain version at the TPU kernel's chunk: the same function
    yc, hc = ssd_scan_plain(x, Bm, Cm, la, chunk=chunk)
    _scan_close(yc, hc, *ssd_scan_ref(jx, jB, jC, jla), dtype)


@pytest.mark.parametrize("S", (48, 100))
def test_ssd_plain_matches_ops_interpret_at_ragged_lengths(S):
    (jx, jB, jC, jla), (x, Bm, Cm, la) = _scan_inputs(1, S, 2, 16, 16,
                                                      "float32", seed=12)
    y, h = ssd_scan(x, Bm, Cm, la)
    _scan_close(y, h, *ref_ssd_ops(jx, jB, jC, jla, interpret=True),
                "float32")
    _scan_close(y, h, *ssd_scan_ref(jx, jB, jC, jla), "float32")
    # a chunk that does not divide S leaves a short last chunk: still exact
    yc, hc = ssd_scan_plain(x, Bm, Cm, la, chunk=32)
    _scan_close(yc, hc, *ssd_scan_ref(jx, jB, jC, jla), "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_plain_with_initial_state_matches_ref(dtype):
    (jx, jB, jC, jla), (x, Bm, Cm, la) = _scan_inputs(2, 100, 3, 16, 32,
                                                      dtype, seed=5)
    h0 = np.random.default_rng(6).standard_normal((2, 3, 16, 32)).astype(
        np.float32)
    y, h = ssd_scan(x, Bm, Cm, la, initial_state=torch.from_numpy(h0))
    _scan_close(y, h, *ssd_scan_ref(jx, jB, jC, jla,
                                    initial_state=jnp.asarray(h0)), dtype)


def test_ssd_wrapper_rejects_bad_inputs():
    _, (x, Bm, Cm, la) = _scan_inputs(1, 16, 2, 16, 16, "float32")
    with pytest.raises(ValueError, match="log_a"):
        ssd_scan(x, Bm, Cm, la[:, :8])
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x, Bm, Cm, la.to(torch.bfloat16))
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, Bm, Cm, la, initial_state=torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2), Bm, Cm, la)


# ------------------------------------------------------------ SSM layer


def _ssm_params(seed=0, A_log=None):
    """Reduced mamba2's SSM layer, with the per-head scalars drawn too
    (the init's A_log = 0, dt_bias = 0 decays the state within a few
    tokens and would hide the carried state)."""
    cfg = ref_get_config("mamba2-130m", reduced=True)
    sc, d = cfg.ssm, cfg.d_model
    p = jax.tree.map(np.asarray, ref_init_params(RS.ssm_defs(sc, d),
                                                 jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    H = p["A_log"].shape[0]
    p["A_log"] = (rng.uniform(-3.0, 0.5, H) if A_log is None
                  else np.full(H, A_log)).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2.0, 1.0, H).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    p["norm_scale"] = (0.1 * rng.standard_normal(
        p["norm_scale"].shape)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(
        np.float32)
    return sc, d, p, params_from_numpy(p, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_cache", [False, True])
def test_ssm_forward_matches_reference(dtype, with_cache):
    sc, d, rp, tp = _ssm_params()
    jdt, tdt = DTYPES[dtype]
    x = _x((2, 64, d), 1)
    jc = RS.init_ssm_cache(sc, d, 2, jdt) if with_cache else None
    tc = TS.init_ssm_cache(sc, d, 2, tdt, "cpu") if with_cache else None
    want, wc = RS.ssm_forward(sc, rp, jnp.asarray(x, jdt), cache=jc)
    got, gc = TS.ssm_forward(sc, tp, torch.from_numpy(x).to(tdt), cache=tc)
    assert got.dtype == tdt and got.shape == (2, 64, d)
    _close(got, want, REL[dtype])
    if with_cache:
        assert gc["conv"].dtype == tdt and gc["ssm"].dtype == torch.float32
        _close(gc["conv"], wc["conv"], REL[dtype])
        _close(gc["ssm"], wc["ssm"], REL[dtype])
    else:
        assert gc is None and wc is None


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_decode_matches_reference(dtype):
    sc, d, rp, tp = _ssm_params(seed=1)
    jdt, tdt = DTYPES[dtype]
    _, H = TS._dims(sc, d)
    conv = _x((3, sc.conv_width - 1, sc.expand * d + 2 * sc.d_state), 2)
    state = _x((3, H, sc.head_dim, sc.d_state), 3)
    x = _x((3, 1, d), 4)
    want, wc = RS.ssm_decode(sc, rp, jnp.asarray(x, jdt),
                             {"conv": jnp.asarray(conv, jdt),
                              "ssm": jnp.asarray(state)})
    got, gc = TS.ssm_decode(sc, tp, torch.from_numpy(x).to(tdt),
                            {"conv": torch.from_numpy(conv).to(tdt),
                             "ssm": torch.from_numpy(state)})
    assert got.dtype == tdt and gc["ssm"].dtype == torch.float32
    _close(got, want, REL[dtype])
    _close(gc["conv"], wc["conv"], REL[dtype])
    _close(gc["ssm"], wc["ssm"], REL[dtype])


def _chunked_vs_whole(forward, p, x, sc, d):
    """One SSM layer: prefill x whole, and in two chunks through the
    cache; returns (second half whole, second half chunked)."""
    S = x.shape[1]
    whole, _ = forward(sc, p, x)
    c = (RS.init_ssm_cache(sc, d, x.shape[0], jnp.float32)
         if isinstance(x, jax.Array)
         else TS.init_ssm_cache(sc, d, x.shape[0], torch.float32, "cpu"))
    _, c = forward(sc, p, x[:, :S // 2], cache=c)
    second, _ = forward(sc, p, x[:, S // 2:], cache=c)
    return whole[:, S // 2:], second


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP C-ref4: ssm_forward writes the final state into the cache but "
    "never reads it back, so each chunk of a chunked prefill starts from a "
    "zero state; the port keeps the reference's semantics"))
def test_ssm_chunked_prefill_carries_the_state():
    sc, d, _, tp = _ssm_params(A_log=-4.0)
    x = torch.from_numpy(_x((1, 64, d), 7))
    whole, chunked = _chunked_vs_whole(TS.ssm_forward, tp, x, sc, d)
    _close(chunked, whole.numpy(), 1e-3)


def test_ssm_chunked_prefill_matches_the_reference_on_c_ref4_example():
    sc, d, rp, tp = _ssm_params(A_log=-4.0)
    x = _x((1, 64, d), 7)
    rw, rc = _chunked_vs_whole(RS.ssm_forward, rp, jnp.asarray(x), sc, d)
    tw, tc = _chunked_vs_whole(TS.ssm_forward, tp, torch.from_numpy(x), sc,
                               d)
    _close(tw, rw, REL["float32"])
    _close(tc, rc, REL["float32"])
    # the fault itself, at the size ROADMAP records it
    assert float(np.abs(np.asarray(rc) - np.asarray(rw)).max()) > 1.0


# ---------------------------------------------------------------- model


def _model(param_dtype):
    ref_cfg = ref_get_config("mamba2-130m", reduced=True).replace(
        param_dtype=param_dtype)
    cfg = get_config("mamba2-130m", reduced=True).replace(
        param_dtype=param_dtype)
    rp = jax.tree.map(np.asarray, RM.init_model(ref_cfg,
                                                jax.random.PRNGKey(1)))
    return ref_cfg, cfg, rp, params_from_numpy(rp, "cpu")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mamba2_prefill_and_decode_match_reference(param_dtype):
    ref_cfg, cfg, rp, tp = _model(param_dtype)
    rel = REL[param_dtype]
    rng = np.random.default_rng(8)
    B, S = 2, 64
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want, wc = RM.forward_prefill(ref_cfg, rp, jnp.asarray(toks),
                                  jnp.asarray(pos),
                                  RM.init_cache(ref_cfg, B, 128, jnp.float32))
    got, gc = TM.forward_prefill(cfg, tp, torch.from_numpy(toks),
                                 torch.from_numpy(pos),
                                 TM.init_cache(cfg, B, 128, torch.float32,
                                               "cpu"))
    assert got.shape == (B, 1, cfg.vocab_size)
    _close(got, want, rel)
    assert len(gc) == len(wc) == 1
    for k in ("conv", "ssm"):
        assert gc[0]["b0"][k].shape == wc[0]["b0"][k].shape
        _close(gc[0]["b0"][k], wc[0]["b0"][k], rel)

    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    dpos = np.full((B,), S, np.int32)
    want, wc = RM.forward_decode(ref_cfg, rp, jnp.asarray(nxt),
                                 jnp.asarray(dpos), wc)
    got, gc = TM.forward_decode(cfg, tp, torch.from_numpy(nxt),
                                torch.from_numpy(dpos), gc)
    _close(got, want, rel)
    for k in ("conv", "ssm"):
        _close(gc[0]["b0"][k], wc[0]["b0"][k], rel)


def test_init_params_follows_the_reference_rules():
    cfg = get_config("mamba2-130m", reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = TM.init_model(cfg, gen, device="cpu")
    ref = jax.tree.map(np.asarray, RM.init_model(
        ref_get_config("mamba2-130m", reduced=True), jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(jax.tree.leaves(p))
    for path, want in flat:
        got = p
        for k in path:
            got = got[k.key]
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        if float(np.std(want)) == 0.0:  # zeros, ones, const:
            np.testing.assert_array_equal(got.numpy(), want)
        else:  # fan-in normal: same scale, other numbers
            assert float(got.std()) == pytest.approx(float(np.std(want)),
                                                     rel=0.2)
    again = TM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], p["embed"])
