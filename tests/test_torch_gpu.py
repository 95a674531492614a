"""The port's CUDA kernels held to their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
kernels have no CPU mode); on the machine with the card run them with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.  The
plain versions are held to the JAX reference on the CPU by
``tests/test_torch_kernels.py``; this file imports no JAX, since the
machine with the card has none.  Kernel and plain version both compute
in f32 and round the output once: f32 is held to 3e-5, bf16 to one bf16
rounding step (2**-7 of the value, plus 1e-5).
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.calibration import CalibrationGrid, calibrate
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_plain)
from repro_torch.kernels.prefill_attention.ops import (
    prefill_attention, prefill_attention_plain)
from repro_torch.telemetry.timing import timeit_median_cuda

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-5, 2.0 ** -7)}  # atol, rtol
PREFILL_KW = [dict(causal=True), dict(causal=True, window=96),
              dict(causal=True, attn_softcap=50.0),
              dict(causal=True, prefix_len=64), dict(causal=False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(device, dtype, *shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        device=device, dtype=DTYPES[dtype]) for s in shapes]


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,D", [(8, 512, 14, 2, 64),
                                        (4, 300, 4, 2, 32),
                                        (2, 1000, 8, 4, 128),
                                        (2, 64, 8, 4, 256),
                                        (64, 4096, 14, 2, 64)])
def test_decode_kernel_matches_plain(cuda, dtype, B, S, H, KV, D):
    q, k, v = _randn(cuda, dtype, (B, 1, H, D), (B, S, KV, D), (B, S, KV, D))
    lens = [S, 0, S // 2, 1][:B] + [S - i for i in range(max(0, B - 4))]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n = decode_attention.launches
    out = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    _close(out, decode_attention_plain(q, k, v, kv_len), dtype)
    if B > 1:
        assert not out[1].any()  # kv_len == 0 writes zeros


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_window_softcap(cuda, dtype):
    B, S = 3, 256
    q, k, v = _randn(cuda, dtype, (B, 1, 4, 32), (B, S, 2, 32), (B, S, 2, 32))
    kv_len = torch.tensor([200, 256, 9], dtype=torch.int32, device=cuda)
    for kw in (dict(window=64), dict(window=64, attn_softcap=20.0),
               dict(window=40, k_positions=torch.arange(
                   S, device=cuda).expand(B, S) + 7,
                    q_positions=kv_len + 6)):
        _close(decode_attention(q, k, v, kv_len, **kw),
               decode_attention_plain(q, k, v, kv_len, **kw), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kw", range(len(PREFILL_KW)))
@pytest.mark.parametrize("B,S,H,KV,D", [(1, 512, 14, 2, 64),
                                        (2, 200, 4, 2, 32),
                                        (1, 130, 8, 4, 128),
                                        (1, 70, 2, 1, 256),
                                        (1, 33, 4, 4, 16)])
def test_prefill_kernel_matches_plain(cuda, dtype, kw, B, S, H, KV, D):
    kw = PREFILL_KW[kw]
    q, k, v = _randn(cuda, dtype, (B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    n = prefill_attention.launches
    out = prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert prefill_attention.launches == n + 1
    _close(out, prefill_attention_plain(q, k, v, **kw), dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, k, v = _randn(cuda, "bfloat16", (1, 8, 4, 48), (1, 8, 2, 48),
                     (1, 8, 2, 48))
    with pytest.raises(ValueError, match="head_dim"):
        prefill_attention(q, k, v)  # no D=48 instantiation
    q, k, v = _randn(cuda, "bfloat16", (1, 1, 4, 36), (1, 8, 2, 36),
                     (1, 8, 2, 36))
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, k, v, torch.tensor([8], device=cuda))
    with pytest.raises(ValueError, match="device"):
        decode_attention(q, k, v, torch.tensor([8]))  # kv_len on the CPU
    q, k, v = _randn(cuda, "bfloat16", (1, 1, 4, 32), (1, 0, 2, 32),
                     (1, 0, 2, 32))
    with pytest.raises(ValueError, match="empty"):
        decode_attention(q, k, v, torch.tensor([0], device=cuda))
    q, k, v = _randn(cuda, "bfloat16", (1, 0, 4, 32), (1, 0, 2, 32),
                     (1, 0, 2, 32))
    with pytest.raises(ValueError, match="empty"):
        prefill_attention(q, k, v)


def test_kernels_calibration_runs_on_the_card(cuda):
    n_dec, n_pre = decode_attention.launches, prefill_attention.launches
    art = calibrate("qwen2-0.5b", backend="kernels", reps=2,
                    grid=CalibrationGrid.tiny())
    assert art.backend == "kernels"
    assert art.hw["device"] == torch.cuda.get_device_name(0)
    assert decode_attention.launches > n_dec
    assert prefill_attention.launches > n_pre
    assert all(s.tau > 0 for s in art.samples)


def test_cuda_timer_reads_the_card_not_the_host(cuda):
    x = torch.ones(1024, device=cuda)

    def slow_host_fast_card():  # 2 ms on the host, a few us on the card
        time.sleep(2e-3)
        x.add_(1.0)

    assert timeit_median_cuda(slow_host_fast_card) < 0.5e-3
    spin = 1 << 21  # cycles; about 1 ms at 2 GHz
    t1 = timeit_median_cuda(lambda: torch.cuda._sleep(spin))
    t2 = timeit_median_cuda(lambda: torch.cuda._sleep(2 * spin))
    assert 1.6 < t2 / t1 < 2.4  # twice the cycles, twice the device time


def test_cuda_timer_raises_when_fn_waits_on_the_card(cuda):
    with pytest.raises(RuntimeError, match="wait on the card"):
        timeit_median_cuda(torch.cuda.synchronize, warmup=0, reps=1)
