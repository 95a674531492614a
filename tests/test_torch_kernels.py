"""The port's attention kernels held to the JAX package.

On the CPU the wrappers run the kernels' plain PyTorch versions; these
are held to the reference's ``ref.py`` oracles and to its ``ops``
wrappers run in Pallas interpret mode, at the shapes of
``tests/test_kernels.py``, the calibration grid's odd shapes and
qwen2-0.5b's head layout.  Tolerances are those of the reference's
kernel tests: f32 3e-5 (summation order), bf16 5e-2 (one bf16 rounding
of the output on either side).  ``tests/test_torch_gpu.py`` holds the
CUDA kernels to these plain versions on the card.
"""

import jax  # noqa: F401  (JAX and PyTorch share the process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ops import decode_attention as ref_decode_ops
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.prefill_attention.ops import \
    prefill_attention as ref_prefill_ops
from repro.kernels.prefill_attention.ref import prefill_attention_ref
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 3e-5, "bfloat16": 5e-2}


def _inputs(seed, shapes, dtype):
    """numpy f32 normals -> (jax arrays, torch tensors) in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _prefill(B, S, H, KV, D, dtype, seed=0):
    return _inputs(seed, [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)], dtype)


def _decode(B, S, H, KV, D, dtype, seed=1):
    return _inputs(seed, [(B, 1, H, D), (B, S, KV, D), (B, S, KV, D)], dtype)


PREFILL_KW = [dict(causal=True), dict(causal=True, window=96),
              dict(causal=True, attn_softcap=50.0),
              dict(causal=True, prefix_len=64), dict(causal=False)]


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 32),    # MHA
    (2, 256, 8, 2, 64),    # GQA
    (1, 512, 4, 1, 64),    # MQA
    (1, 96, 14, 2, 64),    # qwen2-0.5b's head layout
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kw", range(len(PREFILL_KW)))
def test_prefill_plain_matches_ref(B, S, H, KV, D, dtype, kw):
    kw = PREFILL_KW[kw]
    (jq, jk, jv), (q, k, v) = _prefill(B, S, H, KV, D, dtype)
    out = prefill_attention(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, prefill_attention_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("C", (17, 48, 100, 128, 300))
@pytest.mark.parametrize("causal", (True, False))
def test_prefill_plain_matches_ref_at_calibration_chunks(C, causal):
    (jq, jk, jv), (q, k, v) = _prefill(1, C, 14, 2, 64, "float32", seed=10)
    _close(prefill_attention(q, k, v, causal=causal),
           prefill_attention_ref(jq, jk, jv, causal=causal), "float32")


@pytest.mark.parametrize("C", (17, 48, 100, 128))
def test_prefill_plain_matches_ops_interpret(C):
    (jq, jk, jv), (q, k, v) = _prefill(1, C, 4, 2, 32, "float32", seed=10)
    _close(prefill_attention(q, k, v),
           ref_prefill_ops(jq, jk, jv, interpret=True), "float32")


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP C-ref1: the reference's ops wrapper zero-pads S to the block "
    "and its kernel lets non-causal queries attend to the padded keys"))
def test_prefill_plain_matches_ops_interpret_noncausal_ragged():
    (jq, jk, jv), (q, k, v) = _prefill(1, 200, 4, 2, 32, "float32", seed=10)
    _close(prefill_attention(q, k, v, causal=False),
           ref_prefill_ops(jq, jk, jv, causal=False, interpret=True),
           "float32")


@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 256, 4, 4, 32),
    (3, 512, 8, 2, 64),
    (1, 1024, 4, 1, 128),
    (3, 100, 14, 2, 64),   # qwen2-0.5b's head layout
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_ref(B, S, H, KV, D, dtype):
    (jq, jk, jv), (q, k, v) = _decode(B, S, H, KV, D, dtype)
    kv_len = np.array([S // 3 + 1, S, max(1, S // 7)][:B], np.int32)
    out = decode_attention(q, k, v, torch.from_numpy(kv_len))
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, decode_attention_ref(jq, jk, jv, jnp.asarray(kv_len)), dtype)


@pytest.mark.parametrize("S", (33, 108, 300))
@pytest.mark.parametrize("vs", ["ref", "ops"])
def test_decode_plain_at_calibration_kv(S, vs):
    (jq, jk, jv), (q, k, v) = _decode(4, S, 4, 2, 32, "float32", seed=11)
    kv_len = np.array([S, max(1, S - 1), max(1, S // 2), max(1, S // 3)],
                      np.int32)
    want = (decode_attention_ref(jq, jk, jv, jnp.asarray(kv_len)) if vs == "ref"
            else ref_decode_ops(jq, jk, jv, jnp.asarray(kv_len),
                                interpret=True))
    _close(decode_attention(q, k, v, torch.from_numpy(kv_len)), want,
           "float32")


def test_decode_plain_ring_window():
    B, S, H, KV, D, W = 2, 256, 4, 2, 32, 64
    (jq, jk, jv), (q, k, v) = _decode(B, S, H, KV, D, "float32", seed=2)
    kv_len = np.array([200, 256], np.int32)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    qpos = kv_len - 1
    want = decode_attention_ref(jq, jk, jv, jnp.asarray(kv_len), window=W,
                                k_positions=jnp.asarray(kpos),
                                q_positions=jnp.asarray(qpos))
    got = decode_attention(q, k, v, torch.from_numpy(kv_len), window=W,
                           k_positions=torch.from_numpy(kpos.copy()),
                           q_positions=torch.from_numpy(qpos))
    _close(got, want, "float32")


def test_decode_plain_window_default_positions_match_tpu_kernel():
    # with window but no positions, the TPU kernel takes slot indices and
    # q = kv_len - 1 (ref.py applies no window then); the port follows it
    (jq, jk, jv), (q, k, v) = _decode(2, 128, 4, 2, 32, "float32", seed=3)
    kv_len = np.array([100, 128], np.int32)
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(kv_len), window=40,
                                   attn_softcap=20.0, block_s=32,
                                   interpret=True)
    _close(decode_attention(q, k, v, torch.from_numpy(kv_len), window=40,
                            attn_softcap=20.0), want, "float32")


def test_decode_plain_empty_row_is_zero_like_tpu_kernel():
    (jq, jk, jv), (q, k, v) = _decode(3, 64, 4, 2, 32, "float32", seed=4)
    kv_len = np.array([64, 0, 17], np.int32)
    got = decode_attention(q, k, v, torch.from_numpy(kv_len))
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(kv_len),
                                   block_s=32, interpret=True)
    _close(got, want, "float32")
    assert not got[1].any()
    # rows with keys still match ref.py, which differs only at kv_len == 0
    ref = np.asarray(decode_attention_ref(jq, jk, jv, jnp.asarray(kv_len)))
    _close(got[[0, 2]], ref[[0, 2]], "float32")


def test_cpu_calls_do_not_count_launches():
    (_, (q, k, v)) = _prefill(1, 32, 4, 2, 32, "float32")
    n_pre, n_dec = prefill_attention.launches, decode_attention.launches
    prefill_attention(q, k, v)
    decode_attention(q[:, :1], k, v, torch.tensor([32]))
    assert (prefill_attention.launches, decode_attention.launches) == \
        (n_pre, n_dec)


@pytest.mark.parametrize("call", [
    lambda: prefill_attention(torch.zeros(1, 8, 4, 32),
                              torch.zeros(1, 8, 3, 32),
                              torch.zeros(1, 8, 3, 32)),
    lambda: prefill_attention(torch.zeros(1, 8, 4, 32, dtype=torch.float16),
                              torch.zeros(1, 8, 2, 32, dtype=torch.float16),
                              torch.zeros(1, 8, 2, 32, dtype=torch.float16)),
    lambda: prefill_attention(torch.zeros(1, 8, 4, 32),
                              torch.zeros(1, 8, 2, 32),
                              torch.zeros(1, 8, 2, 32), window=0),
    lambda: decode_attention(torch.zeros(2, 1, 4, 32), torch.zeros(2, 8, 2, 32),
                             torch.zeros(2, 8, 2, 32), torch.tensor([8])),
    lambda: decode_attention(torch.zeros(1, 1, 4, 32),
                             torch.zeros(1, 8, 2, 32).transpose(1, 2),
                             torch.zeros(1, 8, 2, 32), torch.tensor([8])),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises((ValueError, TypeError)):
        call()
