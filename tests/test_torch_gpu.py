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
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_plain,
                                                      decode_plan)
from repro_torch.kernels.prefill_attention.ops import (
    prefill_attention, prefill_attention_plain)
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.models.params import tree_map
from repro_torch.telemetry.timing import timeit_median_cuda

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-5, 2.0 ** -7)}  # atol, rtol
# The SSD scan's y: the plain version at the reference's 256-token chunk
# loses f32 precision in exp(cum_t - cum_s) over long chunks, and kernel
# and plain differed by 6.1e-5 near zero at B=4 S=2048 on an H100
# (chip_smoke.py, SSD_Y_TOL), so y's atol is 1e-4.
SSD_Y_TOL = {"float32": (1e-4, 3e-5), "bfloat16": (1e-4, 2.0 ** -7)}
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
                                        (64, 4096, 14, 2, 64),
                                        (3, 2000, 14, 2, 64),
                                        (2, 333, 20, 2, 64),
                                        (16, 16, 14, 2, 64)])
def test_decode_kernel_matches_plain(cuda, dtype, B, S, H, KV, D):
    """Ragged kv_len with an empty row; (3, 2000) takes the largest
    cluster (8 blocks) and (2, 333) two passes over G = 10 heads."""
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
    if (B, S) == (3, 2000):
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        assert decode_plan(B, S, H, KV, D, out.element_size(),
                           n_sm).n_split == 8


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,H,KV,D", [(256, 4, 2, 32), (1024, 14, 2, 64)])
def test_decode_kernel_window_softcap(cuda, dtype, S, H, KV, D):
    B = 3
    q, k, v = _randn(cuda, dtype, (B, 1, H, D), (B, S, KV, D), (B, S, KV, D))
    kv_len = torch.tensor([200, S, 9], dtype=torch.int32, device=cuda)
    for kw in (dict(window=64), dict(window=64, attn_softcap=20.0),
               dict(window=40, k_positions=torch.arange(
                   S, device=cuda).expand(B, S) + 7,
                    q_positions=kv_len + 6)):
        _close(decode_attention(q, k, v, kv_len, **kw),
               decode_attention_plain(q, k, v, kv_len, **kw), dtype)


# B=2 at every head dim the tensor-core route tiles differently, at G = 1
# and G = 7, with ragged and whole-tile S
PREFILL_SHAPES = [(1, 512, 14, 2, 64), (2, 200, 4, 2, 32), (1, 130, 8, 4, 128),
                  (1, 70, 2, 1, 256), (1, 33, 4, 4, 16)] + [
    (2, S, H, KV, D) for D in (64, 128, 256) for S in (17, 100, 300, 512)
    for H, KV in ((2, 2), (7, 1))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kw", range(len(PREFILL_KW)))
@pytest.mark.parametrize("B,S,H,KV,D", PREFILL_SHAPES)
def test_prefill_kernel_matches_plain(cuda, dtype, kw, B, S, H, KV, D):
    """bf16 goes through the tensor-core route, f32 the FP32 pipes."""
    kw = PREFILL_KW[kw]
    q, k, v = _randn(cuda, dtype, (B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    route = "launches_tc" if dtype == "bfloat16" else "launches_fp32"
    n, n_route = prefill_attention.launches, getattr(prefill_attention, route)
    out = prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert prefill_attention.launches == n + 1
    assert getattr(prefill_attention, route) == n_route + 1
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


def _scan_inputs(device, dtype, B, S, H, P, N, seed=3):
    """x, Bm, Cm in ``dtype`` and log_a f32, as ``tests/test_kernels.py``
    draws them."""
    x, Bm, Cm = _randn(device, dtype, (B, S, H, P), (B, S, N), (B, S, N),
                       seed=seed)
    rng = np.random.default_rng(seed + 1)
    la = torch.from_numpy(-0.1 * np.abs(rng.standard_normal(
        (B, S, H))).astype(np.float32)).to(device)
    return x, 0.5 * Bm, 0.5 * Cm, la


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,P,N", [(1, 16, 24, 64, 128),
                                       (4, 2048, 24, 64, 128),
                                       (1, 128, 2, 16, 16),
                                       (2, 256, 3, 16, 32),
                                       (1, 512, 4, 32, 64),
                                       (2, 100, 3, 16, 32),
                                       (1, 33, 2, 64, 256),
                                       (2, 127, 4, 64, 128),
                                       (2, 128, 4, 64, 128),
                                       (2, 129, 4, 64, 128),
                                       (4, 16, 24, 64, 128),
                                       (1, 300, 3, 16, 256),
                                       (2, 200, 2, 128, 64)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, B, S, H, P, N,
                                       with_state):
    """bf16 runs the tensor-core route: S = 127, 128, 129 straddle its
    128-token chunk, S = 300 ends on a ragged chunk, P = 128 splits P
    across blocks, and B = 4 S = 16 shares blocks among heads."""
    x, Bm, Cm, la = _scan_inputs(cuda, dtype, B, S, H, P, N)
    h0 = None
    if with_state:
        h0 = _randn(cuda, "float32", (B, H, P, N), seed=9)[0]
    n = ssd_scan.launches
    route = "launches_tc" if dtype == "bfloat16" else "launches_fp32"
    n_route = getattr(ssd_scan, route)
    y, h = ssd_scan(x, Bm, Cm, la, initial_state=h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n + 1
    assert getattr(ssd_scan, route) == n_route + 1
    yp, hp = ssd_scan_plain(x, Bm, Cm, la, initial_state=h0)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    atol, rtol = SSD_Y_TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), atol=atol, rtol=rtol)
    _close(h, hp, "float32")


def test_ssd_scan_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, Bm, Cm, la = _scan_inputs(cuda, "bfloat16", 1, 16, 2, 24, 16)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan(x, Bm, Cm, la)  # P = 24 is not a multiple of 16
    x, Bm, Cm, la = _scan_inputs(cuda, "bfloat16", 1, 16, 2, 16, 12)
    with pytest.raises(ValueError, match="d_state"):
        ssd_scan(x, Bm, Cm, la)  # N = 12 is not a multiple of 8
    x, Bm, Cm, la = _scan_inputs(cuda, "bfloat16", 1, 16, 2, 16, 16)
    with pytest.raises(TypeError, match="dtype"):
        ssd_scan(x.half(), Bm.half(), Cm.half(), la)
    with pytest.raises(ValueError, match="one device and dtype"):
        ssd_scan(x, Bm.float(), Cm, la)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), Bm, Cm, la)
    with pytest.raises(ValueError, match="device"):
        ssd_scan(x, Bm, Cm, la.cpu())
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x, Bm, Cm, la.to(torch.bfloat16))
    with pytest.raises(ValueError, match="empty"):
        ssd_scan(*_scan_inputs(cuda, "bfloat16", 1, 0, 2, 16, 16))


def test_mamba2_serving_runs_through_the_kernel(cuda):
    cfg = get_config("mamba2-130m", reduced=True)
    n = ssd_scan.launches
    m = serve(cfg, servers=2, requests=4, device=cuda)
    assert m.completions == m.arrivals == 4
    n_layers = cfg.n_layers
    assert ssd_scan.launches - n == n_layers * len(m.iter_wall["mixed"])


def test_mamba2_logits_on_the_card_match_the_cpu(cuda):
    cfg = get_config("mamba2-130m", reduced=True)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    pos = torch.arange(64, dtype=torch.int32)[None].expand(2, 64)
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev), params)
        logits, caches = M.forward_prefill(
            cfg, p, toks.to(dev), pos.to(dev),
            M.init_cache(cfg, 2, 128, torch.float32, dev))
        out[str(dev)] = (logits.cpu(), caches[0]["b0"]["ssm"].cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


# ------------------------------------------------- attention serving path


def _n_attn(cfg):
    return sum(s.mixer in ("attn", "attn_local") for s in cfg.block_specs())


def test_qwen2_serving_decodes_through_b1(cuda):
    """Every engine iteration decodes, mixed ones included: B1 launches
    once per attention layer per iteration, on its f32 route (f32
    caches)."""
    cfg = get_config("qwen2-0.5b", reduced=True)
    n, routes = decode_attention.launches, dict(decode_attention.routes)
    m = serve(cfg, servers=2, requests=4, device=cuda)
    assert m.completions == m.arrivals == 4
    iters = len(m.iter_wall["mixed"]) + len(m.iter_wall["solo"])
    assert decode_attention.launches - n == _n_attn(cfg) * iters
    new = {k: v - routes.get(k, 0) for k, v in decode_attention.routes.items()
           if v != routes.get(k, 0)}
    assert {k[0] for k in new} == {"float32"}


def _card_and_cpu(cfg, steps, kernel_impl):
    """One model on the CPU and on the card from the same weights: a whole
    prefill of 40 tokens, two 16-token continuation chunks, ``steps``
    decodes; the logits of every call."""
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(1)
    calls = [(rng.integers(0, cfg.vocab_size, (2, 40)), 0, False)]
    calls += [(rng.integers(0, cfg.vocab_size, (2, 16)), p0, True)
              for p0 in (40, 56)]
    calls += [(rng.integers(0, cfg.vocab_size, (2, 1)), 72 + i, None)
              for i in range(steps)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), params)
        caches = M.init_cache(cfg, 2, 96, torch.float32, dev)
        logits = []
        for toks, p0, cont in calls:
            t = torch.from_numpy(toks.astype(np.int32)).to(dev)
            if cont is None:
                pos = torch.full((2,), p0, dtype=torch.int32, device=dev)
                lg, caches = M.forward_decode(cfg, p, t, pos, caches)
            else:
                pos = (p0 + torch.arange(t.shape[1], dtype=torch.int32,
                                         device=dev))[None].expand(2, -1)
                lg, caches = M.forward_prefill(
                    cfg, p, t, pos, caches, continuation=cont,
                    kernel_impl=kernel_impl)
            logits.append(lg.cpu())
        out[dev] = logits
    return out["cpu"], out["cuda"]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-2b",
                                  "recurrentgemma-2b"])
def test_attention_models_on_the_card_match_the_cpu(cuda, arch):
    """Past the reduced window (32): the local rings wrap.  The card runs
    B2 for the whole prefill and B1 for every decode."""
    cfg = get_config(arch, reduced=True)
    n1, n2 = decode_attention.launches, prefill_attention.launches
    cpu, card = _card_and_cpu(cfg, 8, "pallas")
    assert decode_attention.launches - n1 == 8 * _n_attn(cfg)
    assert prefill_attention.launches - n2 == _n_attn(cfg)
    for a, b in zip(cpu, card):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_whole_prompt_prefill_runs_b2_on_tensor_cores(cuda):
    """bf16 activations and caches: B2 on its tensor-core route for every
    layer, then B1 on its bf16 route."""
    cfg = get_config("qwen2-0.5b", reduced=True).replace(
        param_dtype="bfloat16")
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device=cuda)
    B, S = 2, 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=cuda,
                         generator=gen)
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None].expand(B, S)
    caches = M.init_cache(cfg, B, S + 4, torch.bfloat16, cuda)
    n_tc = prefill_attention.launches_tc
    logits, caches = M.forward_prefill(cfg, params, toks, pos, caches,
                                       kernel_impl="pallas")
    assert prefill_attention.launches_tc - n_tc == cfg.n_layers
    n_bf16 = sum(v for k, v in decode_attention.routes.items()
                 if k[0] == "bfloat16")
    for i in range(4):
        logits, caches = M.forward_decode(
            cfg, params, logits.argmax(-1).to(torch.int32),
            torch.full((B,), S + i, dtype=torch.int32, device=cuda), caches)
    assert sum(v for k, v in decode_attention.routes.items()
               if k[0] == "bfloat16") - n_bf16 == 4 * cfg.n_layers
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


# -- ctmc_scan: the uniformized CTMC's event loop ---------------------------
# Kernel and plain version draw the same Philox numbers and take every sum
# in the same order, so counters are equal and the clock, revenue and
# accumulators agree to 1e-12 relative (in practice bit for bit).
CTMC_POLICIES = ["gate_and_route", "gate_and_route_separate",
                 "prioritize_and_route", "baseline_vllm", "sli_aware",
                 "sli_aware_general"]


def _ctmc_sim(policy, n, dtype, telemetry=False, stepping="events",
              horizon=10.0):
    from repro_torch.core.ctmc_jax import UniformizedCTMC
    from repro_torch.core.planning import (SLISpec, solve_bundled_lp,
                                           solve_separate_lp)
    from repro_torch.core import policies as P
    from repro_torch.core.types import (Pricing, ServicePrimitives,
                                        WorkloadClass)

    classes = [WorkloadClass("decode_heavy", 300, 1000, 0.5, 0.1),
               WorkloadClass("prefill_heavy", 3000, 400, 0.5, 0.1)]
    prim, price = ServicePrimitives(), Pricing(0.1, 0.2)
    pin = solve_bundled_lp(classes, prim, price,
                           sli=SLISpec(pin_zero_decode_queue=True))
    sep = solve_separate_lp(classes, prim, price)
    pol = {"gate_and_route": lambda: P.gate_and_route(pin),
           "gate_and_route_separate": lambda: P.gate_and_route(
               sep, name="s").replace(charging="separate"),
           "prioritize_and_route": lambda: P.prioritize_and_route(sep),
           "baseline_vllm": lambda: P.baseline_vllm(pin),
           "sli_aware": lambda: P.sli_aware_policy(pin),
           "sli_aware_general": lambda: P.sli_aware_policy(
               pin, general=True)}[policy]()
    return UniformizedCTMC(classes, prim, price, pol, n=n, horizon=horizon,
                           warmup=horizon / 4, dtype=DTYPES_CTMC[dtype],
                           telemetry=telemetry, stepping=stepping,
                           device="cuda")


DTYPES_CTMC = {"float32": torch.float32, "float64": torch.float64}


def _ctmc_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in ("t", "rev") or k.startswith("acc"):
            torch.testing.assert_close(got[k], v, rtol=1e-12, atol=0,
                                       msg=k)
        else:
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("telemetry", [False, True],
                         ids=["bare", "telemetry"])
@pytest.mark.parametrize("dtype", list(DTYPES_CTMC))
@pytest.mark.parametrize("policy", CTMC_POLICIES)
def test_ctmc_scan_kernel_matches_plain(cuda, policy, dtype, telemetry):
    from repro_torch.compat import prng_key
    from repro_torch.kernels.ctmc_scan.ops import (ctmc_scan,
                                                   ctmc_scan_plain,
                                                   pack_block)

    sim = _ctmc_sim(policy, 12, dtype, telemetry)
    fp, ip = pack_block(sim.params, sim._static,
                        torch.stack([prng_key(s) for s in range(6)]))
    nb = sim.telemetry.n_bins if telemetry else 0
    n = ctmc_scan.launches
    got = ctmc_scan(fp, ip, n_classes=2, n_bins=nb)
    assert ctmc_scan.launches == n + 1
    want = ctmc_scan_plain(fp, ip, n_classes=2, n_bins=nb)
    _ctmc_equal(got, want)
    assert bool((got["t"] == 10.0).all())
    assert float(got["n_events"].min()) > 0


@pytest.mark.parametrize("dtype", list(DTYPES_CTMC))
@pytest.mark.parametrize("policy", ["gate_and_route", "sli_aware_general"])
def test_ctmc_scan_ticks_mode_matches_plain(cuda, policy, dtype):
    sim = _ctmc_sim(policy, 8, dtype, stepping="ticks", horizon=3.0)
    got = sim.run_batch_raw(range(4))
    from repro_torch.kernels.ctmc_scan.ops import ctmc_scan_plain, pack_block
    from repro_torch.compat import prng_key

    fp, ip = pack_block(sim.params, sim._static,
                        torch.stack([prng_key(s) for s in range(4)]))
    _ctmc_equal(got, ctmc_scan_plain(fp, ip, n_classes=2))
    assert float(got["clip_steps"].sum()) == 0.0


def test_ctmc_scan_cells_of_different_size_share_a_launch(cuda):
    """Two sizes and both schemes in one launch equal each cell's own."""
    from repro_torch.core.ctmc_jax import run_cells_raw
    from repro_torch.kernels.ctmc_scan.ops import ctmc_scan

    cells = [(_ctmc_sim("gate_and_route", 8, "float64"), [0, 1]),
             (_ctmc_sim("gate_and_route_separate", 20, "float64"), [2])]
    n = ctmc_scan.launches
    joint = run_cells_raw(cells)
    assert ctmc_scan.launches == n + 1
    for (sim, seeds), raw in zip(cells, joint):
        _ctmc_equal(raw, sim.run_batch_raw(seeds))


@pytest.mark.parametrize("dtype,telemetry",
                         [("float64", False), ("float64", True),
                          ("float32", False)],
                         ids=["float64", "float64-telemetry", "float32"])
def test_ctmc_scan_resumes_across_launches_at_large_n(cuda, monkeypatch,
                                                      dtype, telemetry):
    """n=16 and n=65536, both schemes, in one call, as the gap run packs
    its cells: in one launch and in launches of 500 steps, whose carry,
    probes and generator counter resume from device memory, both equal to
    the plain version.  n=65536 runs to horizon 0.03 (~4.6 k steps, the
    first decode completions) so that the plain version can follow."""
    from repro_torch.compat import prng_key
    from repro_torch.kernels.ctmc_scan import ops

    sims = [_ctmc_sim(p, n, dtype, telemetry, horizon=h)
            for n, h in ((16, 10.0), (65536, 0.03))
            for p in ("gate_and_route", "gate_and_route_separate")]
    parts = [ops.pack_block(s.params, s._static,
                            torch.stack([prng_key(k) for k in range(3)]))
             for s in sims]
    fp = torch.cat([p[0] for p in parts])
    ip = torch.cat([p[1] for p in parts])
    nb = sims[0].telemetry.n_bins if telemetry else 0
    n = ops.ctmc_scan.launches
    one = ops.ctmc_scan(fp, ip, n_classes=2, n_bins=nb)
    assert ops.ctmc_scan.launches == n + 1
    monkeypatch.setattr(ops, "_BLOCK_STEPS", 500)
    many = ops.ctmc_scan(fp, ip, n_classes=2, n_bins=nb)
    assert ops.ctmc_scan.launches - n - 1 >= 5
    want = ops.ctmc_scan_plain(fp, ip, n_classes=2, n_bins=nb)
    _ctmc_equal(one, want)
    _ctmc_equal(many, want)
    horizon = torch.cat([torch.full((3,), s.horizon, dtype=fp.dtype,
                                    device=fp.device) for s in sims])
    assert torch.equal(one["t"], horizon)
    assert float(one["n_events"][6:].min()) > 1000  # n=65536 rows


@pytest.mark.parametrize("dtype", list(DTYPES_CTMC))
def test_ctmc_scan_resumes_off_the_ring_blocks(cuda, monkeypatch, dtype):
    """Launches of 37 steps start off the ring's 32-step blocks (s0 = 37,
    74, ...): the ring is indexed by the absolute step, so they equal the
    plain version."""
    from repro_torch.compat import prng_key
    from repro_torch.kernels.ctmc_scan import ops

    sim = _ctmc_sim("gate_and_route", 12, dtype, telemetry=True)
    fp, ip = ops.pack_block(sim.params, sim._static,
                            torch.stack([prng_key(s) for s in range(5)]))
    monkeypatch.setattr(ops, "_BLOCK_STEPS", 37)
    n = ops.ctmc_scan.launches
    got = ops.ctmc_scan(fp, ip, n_classes=2, n_bins=sim.telemetry.n_bins)
    assert ops.ctmc_scan.launches - n >= 5
    _ctmc_equal(got, ops.ctmc_scan_plain(fp, ip, n_classes=2,
                                         n_bins=sim.telemetry.n_bins))
    assert bool((got["t"] == 10.0).all())


def test_ctmc_scan_raises_above_its_class_cap(cuda):
    from repro_torch.kernels.ctmc_scan.ops import (FSCAL, FVEC, IPAR,
                                                   MAX_CLASSES, ctmc_scan)

    I = MAX_CLASSES + 1
    fp = torch.zeros((1, len(FVEC) * I + len(FSCAL)), dtype=torch.float64,
                     device="cuda")
    ip = torch.zeros((1, len(IPAR)), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="MAX_CLASSES"):
        ctmc_scan(fp, ip, n_classes=I)
    with pytest.raises(ValueError, match="int64"):
        ctmc_scan(fp[:, :len(FVEC) * 2 + len(FSCAL)].contiguous(),
                  ip.int(), n_classes=2)


# ------------------------------------------------- the trace-replay engines
ENGINE_RTOL = 1e-5  # times and revenue, float32 (the reference's tolerance)
ENGINE_FLOATS = ("t_first", "t_last", "rev", "t", "t_next", "pf_left",
                 "t_buf", "tlm_busy_srv", "tlm_busy_bin")


def _engine_instance(seed=42, compression=1.0, horizon=10.0):
    from repro_torch.core.planning import SLISpec, solve_bundled_lp
    from repro_torch.core.types import (Pricing, ServicePrimitives,
                                        WorkloadClass)
    from repro_torch.data.traces import (TraceConfig, synth_azure_trace,
                                         tensorize_trace, trace_class_means)

    trace = synth_azure_trace(TraceConfig(horizon=horizon, base_rate=2.0,
                                          compression=compression, seed=seed))
    classes = [WorkloadClass(nm, m[0], m[1], m[2] / 8, patience=3e-4)
               for nm, m in zip(("code", "conv"),
                                trace_class_means(trace, 2))]
    plan = solve_bundled_lp(classes, ServicePrimitives(), Pricing(0.1, 0.2),
                            sli=SLISpec(pin_zero_decode_queue=True))
    return (tensorize_trace(trace, pad_to=max(64, len(trace))), classes,
            plan)


def _engine(name, device, seed=42, **kw):
    from repro_torch.core import policies as po
    from repro_torch.core.types import Pricing, ServicePrimitives
    from repro_torch.serving.engine_jax import ClusterEngineJAX
    from repro_torch.serving.engine_sim import EngineConfig

    make = {"gate_and_route": po.gate_and_route, "vllm": po.baseline_vllm,
            "sarathi": po.baseline_sarathi,
            "distserve": lambda p: po.baseline_distserve(p, 3),
            "prioritize": po.prioritize_and_route,
            "sli": po.sli_aware_policy,
            "sli_general": lambda p: po.sli_aware_policy(p, general=True)}
    tt, classes, plan = _engine_instance(seed)
    return ClusterEngineJAX(classes, make[name](plan), EngineConfig(
        ServicePrimitives(), Pricing(0.1, 0.2), n_servers=8), tt,
        horizon=10.0, device=device, **kw)


def _engine_equal(card, cpu):
    assert card.keys() == cpu.keys()
    for k in cpu:
        x = cpu[k].numpy().astype(np.float64)
        y = card[k].cpu().numpy().astype(np.float64)
        if k in ENGINE_FLOATS:
            np.testing.assert_allclose(y, x, rtol=ENGINE_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("gate_and_route", {}), ("vllm", {}), ("sarathi", {}),
    ("distserve", {}), ("prioritize", {}), ("sli", {}), ("sli_general", {}),
    ("gate_and_route", dict(fastforward=True)),
    ("gate_and_route", dict(fastforward=True, k_events=3, telemetry=True)),
    ("vllm", dict(k_events=2, loop="scan")),
], ids=lambda v: str(v))
def test_engine_card_matches_cpu_route(cuda, name, kw):
    """Every raw carry array of the CUDA-graph replay equal to the CPU
    route's (times and revenue within ENGINE_RTOL); the randomized router
    draws the same Philox bits on both."""
    from repro_torch.serving import engine_jax as ej

    r0 = ej.run.graph_replays
    card = _engine(name, None, **kw).run_batch_raw([0, 1, 2])
    assert ej.run.graph_replays > r0
    _engine_equal(card, _engine(name, "cpu", **kw).run_batch_raw([0, 1, 2]))


def test_engine_partial_block_at_the_budget_cap(cuda):
    """A step budget that ends inside a block: the guarded steps past it
    change nothing, on the card as on the CPU."""
    from repro_torch.serving import engine_jax as ej

    steps = 3 * ej.BLOCK_STEPS + 7
    card = _engine("gate_and_route", None, max_steps=steps)
    got = card.run_batch_raw([0, 1])
    _engine_equal(got, _engine("gate_and_route", "cpu",
                               max_steps=steps).run_batch_raw([0, 1]))
    m = card.summaries_from_raw(got)[0]
    assert m["budget_exhausted"] == 1.0 and m["n_events"] == steps


def test_engine_graph_is_reused_for_a_new_trace_of_the_same_shape(cuda):
    """The cached graph's buffers are refilled from each call: a second
    trace of the same padded shape replays the first one's capture and
    still equals its CPU replay."""
    from repro_torch.serving import engine_jax as ej

    _engine("vllm", None, seed=42).run_batch_raw([0])
    n = len(ej._Blocks._cache)
    card = _engine("vllm", None, seed=43).run_batch_raw([0])
    assert len(ej._Blocks._cache) == n
    _engine_equal(card, _engine("vllm", "cpu", seed=43).run_batch_raw([0]))


def test_engine_stream_on_the_card_matches_the_cpu(cuda):
    import dataclasses

    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import Pricing, ServicePrimitives
    from repro_torch.data.traces import TraceConfig, synth_azure_trace
    from repro_torch.serving.engine_sim import EngineConfig
    from repro_torch.serving.engine_stream import (StreamingEngineJAX,
                                                   TraceChunkSource)

    _, classes, plan = _engine_instance(7, 0.3, 30.0)
    trace = [dataclasses.replace(r, patience=float("inf"))
             for r in synth_azure_trace(TraceConfig(
                 horizon=30.0, base_rate=2.0, compression=0.3, seed=7))]
    out = {}
    for dev in (None, "cpu"):
        eng = StreamingEngineJAX(classes, gate_and_route(plan), EngineConfig(
            ServicePrimitives(), Pricing(0.1, 0.2), n_servers=8),
            horizon=30.0, window=512, device=dev)
        out[dev] = eng.run_stream(TraceChunkSource(trace, chunk_size=64))
    a, b = out[None], out["cpu"]
    for k in ("arrivals", "completions", "abandons", "n_events", "n_iters",
              "n_loop", "n_segments", "window_occupancy"):
        assert a[k] == b[k], k
    assert a["revenue_rate"] == pytest.approx(b["revenue_rate"],
                                              rel=ENGINE_RTOL)


@pytest.mark.parametrize("scenario", [
    "agentic_loops", "azure_2023", "azure_2024", "capacity_churn",
    "conv_latent", "diurnal", "dolly_mix", "flash_crowd", "link_degrade",
    "rag_heavy", "rate_shift", "reasoning_long"])
def test_engine_registry_scenario_60s_budget_not_exhausted(cuda, scenario):
    """The reference's registry run at its own 60 s horizon, on the card
    (tests/test_torch_engine_stream.py cuts it to 20 s on the CPU)."""
    from repro_torch.core.planning import solve_bundled_lp
    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import (Pricing, ServicePrimitives,
                                        WorkloadClass)
    from repro_torch.data.traces import tensorize_trace
    from repro_torch.serving.engine_jax import ClusterEngineJAX
    from repro_torch.serving.engine_sim import EngineConfig
    from repro_torch.serving.engine_stream import StreamingEngineJAX
    from repro_torch.workloads import get_scenario
    from repro_torch.workloads.batch import ScenarioStream

    prim, price = ServicePrimitives(), Pricing(0.1, 0.2)
    sc = get_scenario(scenario)
    shares = np.array([p.share for p in sc.profiles])
    shares = shares / shares.sum()
    classes = [WorkloadClass(p.name, int(p.mean_prompt), int(p.mean_decode),
                             max(float(2.0 * sh / 6), 1e-3))
               for p, sh in zip(sc.profiles, shares)]
    plan = solve_bundled_lp(classes, prim, price)
    cfg = EngineConfig(prim, price, n_servers=6)
    if all(np.isinf(p.patience) for p in sc.profiles):
        m = StreamingEngineJAX(classes, gate_and_route(plan), cfg,
                               horizon=60.0, window=4096).run_stream(
            ScenarioStream(sc, seed=0, chunk_size=512, horizon=60.0), seed=0)
    else:
        m = ClusterEngineJAX(classes, gate_and_route(plan), cfg,
                             tensorize_trace(sc.generate(seed=0,
                                                         horizon=60.0)),
                             horizon=60.0).run(0)
    assert m["budget_exhausted"] == 0.0 and m["arrivals"] > 0


def test_engine_generate_batch_on_the_card_matches_the_cpu(cuda):
    """The same Philox bits on both devices: discrete draws equal up to
    the last bits of log/exp (arrival times within 1e-5 relative)."""
    from repro_torch.workloads import get_scenario
    from repro_torch.workloads.batch import generate_batch

    scns = [get_scenario("rate_shift"), get_scenario("agentic_loops")]
    a = generate_batch(scns, [0, 1], horizon=60.0)
    b = generate_batch(scns, [0, 1], horizon=60.0, device="cpu")
    np.testing.assert_array_equal(a["n_real"], b["n_real"])
    np.testing.assert_array_equal(a["cls"], b["cls"])
    v = b["valid"]
    np.testing.assert_allclose(a["t"][v], b["t"][v], rtol=1e-5)
