#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device -- a CUDA card must be visible; prints its name and power limit
   as ``nvidia-smi`` reports them;
2. build -- compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints ``ptxas``'s resource
   report, one line per kernel instantiation;
3. kernels vs plain -- calls each kernel's wrapper on the card at the
   shapes the calibration loop gives it (bf16 and f32), at the shapes of
   phase 6 (the engine's decode, B=4 S=256; the whole-prompt prefill,
   B=4 S=2048), at odd and masked
   shapes, and at one large shape per kernel and dtype, and holds each
   result to the kernel's plain PyTorch version on the same inputs
   (``TOL``).  Each bf16 prefill call must go through the tensor-core
   route.  Prints, per shape: the route (prefill: ``tc`` or ``fp32``;
   decode: the cluster plan), max error, kernel ms, plain ms,
   ``scaled_dot_product_attention``
   ms (a yardstick the port never calls), each the device time that
   ``timeit_median_cuda`` gives, as the calibration measures it, and the
   bound: the larger of the bytes the function must move over 3.35 TB/s
   and its FLOPs over the peak rate of its type (989 TFLOP/s bf16
   tensor-core, 67 TFLOP/s f32), the H100 SXM data sheet;
3b. SSD scan vs plain -- the same for the Mamba-2 chunk scan (B3), bf16
   and f32: the serving engine's chunk (B=1 S=16, mamba2-130m's heads
   H=24 P=64 N=128), the config's chunk (B=4 S=2048), the odd shapes of
   ``tests/test_kernels.py``, a ragged S with an initial state, S on
   either side of the bf16 route's 128-token chunk, N=256 beside P=16,
   and one large shape (B=8 S=8192).  Each call must go through its
   dtype's route; prints the route (bf16: ``tc``, one chunk from a zero
   state in one launch or chunks in parallel in three; f32: ``fp32``)
   and y's distance from a float64 run of the plain version.  The plain version launches too many kernels
   to queue behind a spin, so it is captured in a CUDA graph and the
   graph's replay is timed.  The bound counts the FLOPs of the cheapest
   exact chunking, one token (the recurrence).  No single PyTorch call
   computes this function, so it has no library time;
4. main path -- the paper's calibrated control loop for qwen2-0.5b at its
   published width, through the port's public API: ``calibrate`` on the
   kernels backend over the default grid, the fitted and seed
   iteration-time models, the bundled planning LP, gate-and-route, and a
   ``ClusterEngine`` replay of the Azure-like trace on 10 servers.  The
   kernel launch counters are zeroed just before and read just after; each
   kernel must have launched, every prefill launch on the tensor-core
   route.  A fitted surface with R^2 below 0.95 is
   printed as not to be trusted.  The same loop on the deterministic
   roofline backend must reproduce the JAX reference's revenue rates.
5. serving path -- mamba2-130m at its published width and depth (random
   weights from ``init_params``) through ``launch.serve.serve`` with the
   traffic of the reference's ``launch/serve.py`` (4 servers, 24
   requests, batch cap 4, chunk 16): every request must complete, and ``ssd_scan`` must launch
   once per SSM layer per prefill chunk (the counters are zeroed just
   before).  Prints the summary and the mixed and solo iterations' host
   wall times.  The same run again under ``torch.profiler`` gives the
   device time inside its own iterations, hence the card's idle share.
   Then a whole-prompt ``forward_prefill`` at B=4 S=2048 must give finite
   logits, and reduced mamba2's logits on the card must match the CPU's
   (plain versions) on the same weights within 1e-4.
6. attention serving path -- qwen2-0.5b at its published width and depth
   (random f32 weights; f32 caches, so B1 runs its f32 route) through the
   same ``serve`` run, the same profiler window and the same prints:
   every request must complete and B1 must launch once per attention
   layer per engine iteration (every iteration decodes); its launches
   print by dtype and cluster plan.  Then whole-prompt
   ``forward_prefill(kernel_impl="pallas")`` with bf16 caches and decodes
   on them: qwen2-0.5b at B=4 S=2048 (16 decodes) and gemma2-2b at B=1
   S=4608 (4 decodes, past its 4096 window, so the local rings wrap):
   B2 once per attention layer on its tensor-core route, B1 once per
   layer per decode on its bf16 route, finite logits.  Reduced qwen2,
   gemma2 and recurrentgemma on the card must match the CPU within 1e-4
   over a whole prefill, two continuation chunks and 8 decodes.
7. optimality gap -- the path of the paper's headline claim (Theorems
   2-3), ``benchmarks/bench_optimality_gap.py``'s instance: the two
   overloaded classes (lambda = 1.0, patience 0.1) under the default
   primitives and pricing, bundled and separate.  R* from the simplex must
   be the artifact's (570.679, 574.012) and the batched interior point on
   the card must agree to 1e-6.  ``ctmc_scan`` (the uniformized CTMC's
   event loop) must equal its plain version at n=16, 8 seeds, horizon 40,
   with n=65536, 2 seeds, horizon 0.03, float64, both schemes and one
   telemetry run, in one launch and in launches of 500 steps: every
   counter exactly, the clock, revenue and accumulators to 1e-12.  Then
   the gap at the artifact's smallest and largest n (16: 32 seeds, horizon
   300; 65536: 3 seeds, horizon 100), float64, both schemes in ONE launch
   (the counts zeroed just before): every replication must reach the
   horizon, each gap must lie within 4 sigma of
   ``artifacts/bench/optimality_gap.json``, fall from n=16 to n=65536, and
   stay above the artifact's -1% noise floor.  Last,
   ``fluid_steady_state`` of the bundled plan on the card (horizon 300,
   dt 2e-3, eager) must reach the LP as
   ``tests/test_fluid_ctmc.py`` requires.  Prints each row's z-score,
   steps, time and events/s.

It then prints the per-kernel JSON line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2-0.5b"
N_SERVERS = 10
HORIZON = 40.0
HBM_BW = 3.35e12  # B/s, H100 SXM
PEAK = {"bfloat16": 989e12, "float32": 67e12}  # FLOP/s by input type
# (atol, rtol) of a kernel against its plain version.  Both compute in f32
# and round the output once, so in bf16 they may differ by one rounding
# step, at most 2**-7 of the value; f32 leaves only summation order.
TOL = {"bfloat16": (1e-5, 2.0 ** -7), "float32": (3e-5, 3e-5)}
# The SSD scan's y against its plain version.  At the reference's
# 256-token chunk the plain version loses f32 precision in
# exp(cum_t - cum_s), |cum| reaching about 20 in a chunk: on an H100 at
# B=4 S=2048 (f32) it was 1.5e-4 off a float64 run where the kernel was
# 2.7e-5 off, and the card tests found kernel and plain 6.1e-5 apart at
# values near zero.  So y's atol is 1e-4 (the reference's kernel test
# allows 2e-4).  The final state is f32 in both dtypes and held to
# TOL["float32"].
SSD_Y_TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float32": (1e-4, 3e-5)}
SSD_ARCH = "mamba2-130m"
# the serving run's iterations (all engines') that torch.profiler records:
# 12 mixed and 48 solo ones (the run's timeline is virtual, so the same on
# any device)
PROFILE_FROM, PROFILE_N = 150, 60
R2_TRUST = 0.95  # PERF.md section 2: the limit for trusting a fitted surface
# The JAX reference's revenue rates for this loop on the roofline backend
# (repro.calibration + repro.serving.engine_sim.ClusterEngine, seed
# constants and fitted model); the port reproduces them bit for bit on the
# CPU (tests/test_torch_loop.py).
REF_ROOFLINE_REVENUE = {"seed": 2564.921648134311,
                        "fitted": 3087.8527206313215}
# phase 7: bench_optimality_gap's OVERLOADED_MIX (name, prompt, decode,
# lambda, patience) and the rows of its FULL_SCHEDULE that phase 7 runs,
# n -> (seeds, horizon, warmup)
GAP_CLASSES = (("decode-heavy", 300, 1000, 1.0, 0.1),
               ("prefill-heavy", 3000, 400, 1.0, 0.1))
GAP_SCHEDULE = {16: (32, 300.0, 75.0), 65536: (3, 100.0, 50.0)}
GAP_ARTIFACT = ROOT / "artifacts" / "bench" / "optimality_gap.json"
GAP_Z = 4.0  # |gap - artifact| within 4 sqrt(se^2 + se_ref^2)
GAP_FLOOR_PCT = -1.0  # the artifact's noise_floor_pct: below is a stall
LP_AGREE = 1e-6  # solve_plan_batch vs the simplex, relative (PLANNING.md)
CTMC_RTOL = 1e-12  # ctmc_scan vs plain: clock, revenue, accumulators
# ctmc_scan's check call, (n, seeds, horizon): both sizes of the gap run,
# the large one cut to ~4.6 k steps (its first decode completions) so that
# the plain version can follow
CTMC_CHECK = ((16, 8, 40.0), (65536, 2, 0.03))
CTMC_RESUME = 500  # steps a launch in the check's second, resumed run
# FP64 operations of one ctmc_scan step at I classes (events mode): the
# rates 5I products and 6I - 1 sums, the clock's log1p, division, sums and
# comparisons (8), the accumulators 10I + 1, the gate's 6I, the routing,
# pull, abandonment and revenue arithmetic (about 20).  Philox's integer
# work is not counted, so the bound stays a lower bound.
CTMC_FLOPS_PER_STEP = {2: 5 * 2 + 6 * 2 - 1 + 8 + 10 * 2 + 1 + 6 * 2 + 20}
PEAK_FP64 = 34e12  # FLOP/s, H100 SXM, outside the tensor cores


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _print_ptxas(lib: str, log: str) -> None:
    """One ``[build]`` line per kernel from ``ptxas -v``: its
    instantiation, registers, spills."""
    import re
    import shutil

    name, spill = "?", ""
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name, spill = found.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True).stdout.strip() or name
            name = name.replace("repro_torch::(anonymous namespace)::",
                                "").split("(")[0]
            print(f"[build] {lib}: {name}: "
                  f"{line.split(':', 1)[-1].strip()}; {spill}")


def _bound(dtype_name: str, bytes_: float, flops: float):
    t_bytes, t_ops = bytes_ / HBM_BW, flops / PEAK[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _check(torch, name, out, ref, dtype_name, shape_desc, tol=None):
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name} {shape_desc}: bad output "
                             f"{tuple(out.shape)} vs {tuple(ref.shape)}")
    err = (out.float() - ref.float()).abs()
    atol, rtol = tol or TOL[dtype_name]
    if not bool((err <= atol + rtol * ref.float().abs()).all()):
        raise AssertionError(f"{name} {shape_desc}: max abs err "
                             f"{err.max().item()} beyond atol {atol} + rtol "
                             f"{rtol} x |plain|")
    return err.max().item()


def _decode_cases(torch, gen, dt):
    """(description, args, kwargs, kv tokens read) of every decode check;
    qwen2-0.5b's head layout unless a case says otherwise."""
    cases = []

    def make(B, S, kv_len, H=14, KV=2, D=64, **kw):
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda", dtype=dt)
        k = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=dt)
        v = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=dt)
        kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        return (q, k, v, kl), kw

    # the calibration grid: B in {8, 16}, S = ceil(K / B), full caches
    for B in (8, 16):
        for K in (256, 1024, 4096, 8192):
            S = math.ceil(K / B)
            args, kw = make(B, S, [S] * B)
            cases.append((f"B={B} S={S} main", args, kw, B * S))
    # the serving engine's decode: batch cap 4, max_len 256 (phase 6)
    args, kw = make(4, 256, [256] * 4)
    cases.append(("B=4 S=256 engine decode", args, kw, 4 * 256))
    # ragged fills at odd cache lengths, one empty row, ring window, softcap
    for S in (33, 108, 300):
        kl = [S, max(1, S - 1), max(1, S // 2), max(1, S // 3)]
        args, kw = make(4, S, kl)
        cases.append((f"B=4 S={S} ragged", args, kw, sum(kl)))
    args, kw = make(3, 200, [200, 0, 57])
    cases.append(("B=3 S=200 kv_len=0 row", args, kw, 257))
    args, kw = make(2, 256, [200, 256], window=64, attn_softcap=30.0)
    kw["k_positions"] = torch.arange(256, dtype=torch.int32,
                                     device="cuda").expand(2, 256).contiguous()
    kw["q_positions"] = args[3] - 1
    cases.append(("B=2 S=256 window=64 softcap", args, kw, 456))
    args, kw = make(64, 4096, [4096] * 64)
    cases.append(("B=64 S=4096 large", args, kw, 64 * 4096))
    # phase 6's decodes after its whole-prompt prefills, at their last
    # step: qwen2-0.5b at B=4 over 2048 + 16 slots; gemma2-2b's global
    # layers over 4608 + 4 slots and its local layers over the wrapped
    # 4096-slot ring (slot s holds the position of s's residue in
    # 516..4611), both with softcap 50
    args, kw = make(4, 2064, [2064] * 4)
    cases.append(("B=4 S=2064 qwen2 whole-prompt decode", args, kw,
                  4 * 2064))
    gemma = dict(H=8, KV=4, D=256, attn_softcap=50.0)
    args, kw = make(1, 4612, [4612], **gemma)
    cases.append(("B=1 S=4612 D=256 gemma2 global softcap=50", args, kw,
                  4612))
    args, kw = make(1, 4096, [4096], window=4096, **gemma)
    slot = torch.arange(4096, dtype=torch.int32, device="cuda")
    kw["k_positions"] = torch.where(slot < 4612 - 4096, slot + 4096,
                                    slot)[None].contiguous()
    kw["q_positions"] = torch.tensor([4611], dtype=torch.int32,
                                     device="cuda")
    cases.append(("B=1 S=4096 D=256 gemma2 ring window=4096 softcap=50",
                  args, kw, 4096))
    return cases


def _prefill_cases(torch, gen, dt):
    """(description, args, kwargs) of every prefill check; qwen2-0.5b's
    head layout unless a case says otherwise."""
    cases = []

    def make(S, B=1, H=14, KV=2, D=64, **kw):
        q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dt)
        k = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=dt)
        v = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=dt)
        return (q, k, v), kw

    for C in (32, 64, 128, 256, 512):  # the calibration grid's chunks
        cases.append((f"C={C} causal main", *make(C)))
    for C in (17, 48, 100, 300):
        cases.append((f"C={C} non-causal", *make(C, causal=False)))
    cases.append(("C=200 window=96", *make(200, window=96)))
    cases.append(("C=200 prefix=64", *make(200, prefix_len=64)))
    cases.append(("C=200 softcap=50", *make(200, attn_softcap=50.0)))
    cases.append(("C=4096 causal large", *make(4096)))
    # phase 6's whole-prompt prefill of qwen2-0.5b
    cases.append(("B=4 S=2048 causal whole-prompt", *make(2048, B=4)))
    # and gemma2-2b's, past the window: its local and its global layers
    gemma = dict(H=8, KV=4, D=256, attn_softcap=50.0)
    cases.append(("B=1 S=4608 D=256 gemma2 window=4096 softcap=50",
                  *make(4608, window=4096, **gemma)))
    cases.append(("B=1 S=4608 D=256 gemma2 global softcap=50",
                  *make(4608, **gemma)))
    return cases


def _pairs(torch, S, causal=True, window=None, prefix_len=None) -> int:
    """Valid (query, key) pairs of a prefill mask: the work it needs."""
    qp = torch.arange(S)[:, None]
    kp = torch.arange(S)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= qp - kp < window
    if prefix_len is not None:
        mask |= kp < prefix_len
    return int(mask.sum())


def _sdpa(torch, q, k, v, **kw):
    """``scaled_dot_product_attention`` on the port's (B,S,H,D) layout,
    GQA included: the yardstick, never called by the port."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **kw)


def check_kernels(torch):
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain, decode_plan)
    from repro_torch.kernels.prefill_attention.ops import (
        prefill_attention, prefill_attention_plain)
    from repro_torch.telemetry.timing import timeit_median_cuda

    def ms(fn):
        return timeit_median_cuda(fn) * 1e3

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"decode_attention": [], "prefill_attention": []}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        el = torch.finfo(dt).bits // 8

        for desc, (q, k, v, kl), kw, kv_read in _decode_cases(torch, gen,
                                                              dt):
            H, D, KV = q.shape[2], q.shape[3], k.shape[2]
            out = decode_attention(q, k, v, kl, **kw)
            ref = decode_attention_plain(q, k, v, kl, **kw)
            torch.cuda.synchronize()
            err = _check(torch, "decode_attention", out, ref, dname, desc)
            B = q.shape[0]
            bytes_ = (2 * B * H * D + 2 * kv_read * KV * D) * el + 4 * B
            if "k_positions" in kw:
                bytes_ += 4 * k.shape[0] * k.shape[1] + 4 * B
            flops = 4.0 * kv_read * H * D
            lib = None
            if not kw and bool((kl == k.shape[1]).all()):
                lib = ms(_sdpa(torch, q, k, v))
            plan = decode_plan(B, k.shape[1], H, KV, D, el, n_sm)
            row = dict(shape=desc, dtype=dname, max_abs_err=err,
                       route=f"cluster={plan.n_split} "
                       f"split_len={plan.split_len} kw={plan.kw} "
                       f"blocks={plan.blocks}",
                       ms=ms(lambda: decode_attention(q, k, v, kl, **kw)),
                       plain_ms=ms(lambda: decode_attention_plain(
                           q, k, v, kl, **kw)),
                       library_ms=lib)
            row["bound_ms"], row["bound_by"] = _bound(dname, bytes_, flops)
            rows["decode_attention"].append(row)

        route = "tc" if dt == torch.bfloat16 else "fp32"
        for desc, (q, k, v), kw in _prefill_cases(torch, gen, dt):
            H, D, KV = q.shape[2], q.shape[3], k.shape[2]
            n_route = getattr(prefill_attention, f"launches_{route}")
            out = prefill_attention(q, k, v, **kw)
            if getattr(prefill_attention, f"launches_{route}") != n_route + 1:
                raise AssertionError(f"prefill_attention {dname} {desc}: "
                                     f"did not launch the {route} route")
            ref = prefill_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = _check(torch, "prefill_attention", out, ref, dname, desc)
            B, S = q.shape[:2]
            pairs = B * _pairs(torch, S, kw.get("causal", True),
                               kw.get("window"), kw.get("prefix_len"))
            bytes_ = B * (2 * S * H * D + 2 * S * KV * D) * el
            flops = 4.0 * pairs * H * D
            lib = None
            if set(kw) <= {"causal"}:
                lib = ms(_sdpa(torch, q, k, v,
                               is_causal=kw.get("causal", True)))
            row = dict(shape=desc, dtype=dname, max_abs_err=err, route=route,
                       ms=ms(lambda: prefill_attention(q, k, v, **kw)),
                       plain_ms=ms(lambda: prefill_attention_plain(
                           q, k, v, **kw)),
                       library_ms=lib)
            row["bound_ms"], row["bound_by"] = _bound(dname, bytes_, flops)
            rows["prefill_attention"].append(row)

    for name, rs in rows.items():
        for r in rs:
            print(f"[kernel] {name} {r['dtype']} {r['shape']} "
                  f"({r['route']}): max_abs_err={r['max_abs_err']!r} "
                  f"(atol, rtol {TOL[r['dtype']]}) ms={r['ms']!r} "
                  f"plain_ms={r['plain_ms']!r} "
                  f"library_ms={r['library_ms']!r} bound_ms={r['bound_ms']!r} "
                  f"({r['bound_by']})")
    return rows


def _ssd_cases(torch, gen, dt):
    """(description, args, initial state) of every SSD scan check."""
    cases = []

    def make(B, S, H, P, N, state=False):
        x = torch.randn(B, S, H, P, generator=gen, device="cuda", dtype=dt)
        Bm = 0.5 * torch.randn(B, S, N, generator=gen, device="cuda",
                               dtype=dt)
        Cm = 0.5 * torch.randn(B, S, N, generator=gen, device="cuda",
                               dtype=dt)
        la = -0.1 * torch.randn(B, S, H, generator=gen, device="cuda").abs()
        h0 = (torch.randn(B, H, P, N, generator=gen, device="cuda")
              if state else None)
        return (x, Bm, Cm, la), h0

    cases.append(("B=1 S=16 H=24 engine chunk", *make(1, 16, 24, 64, 128)))
    cases.append(("B=4 S=2048 H=24 config chunk",
                  *make(4, 2048, 24, 64, 128)))
    for B, S, H, P, N in ((1, 128, 2, 16, 16), (2, 256, 3, 16, 32),
                          (1, 512, 4, 32, 64)):
        cases.append((f"B={B} S={S} H={H} P={P} N={N} odd",
                      *make(B, S, H, P, N)))
    cases.append(("B=2 S=300 H=24 initial state",
                  *make(2, 300, 24, 64, 128, state=True)))
    # straddling the bf16 route's 128-token chunk, and N, P at the edges
    for S in (127, 128, 129):
        cases.append((f"B=2 S={S} H=24 chunk edge", *make(2, S, 24, 64, 128)))
    cases.append(("B=2 S=16 H=24 engine chunk, initial state",
                  *make(2, 16, 24, 64, 128, state=True)))
    cases.append(("B=2 S=200 H=3 P=16 N=256 initial state",
                  *make(2, 200, 3, 16, 256, state=True)))
    cases.append(("B=1 S=300 H=4 P=16 N=256", *make(1, 300, 4, 16, 256)))
    if dt == torch.bfloat16:
        cases.append(("B=8 S=8192 H=24 large", *make(8, 8192, 24, 64, 128)))
    return cases


def _ssd_work(x, N, el, with_state):
    """(bytes, FLOPs) of one scan: each input read and output written
    once.  Chunking is exact, so the FLOPs are those of the cheapest
    chunking: per (b, h) and chunk of q tokens 2q^2N + 2q^2P + 4qPN
    (C B^T, W x, and C h plus the state update), least at q = 1, the
    per-token recurrence."""
    B, S, H, P = x.shape
    bytes_ = el * (2 * B * S * H * P + 2 * B * S * N) + 4 * B * S * H \
        + 4 * B * H * P * N * (2 if with_state else 1)
    return bytes_, B * S * H * (2.0 * N + 2.0 * P + 4.0 * P * N)


def _graphed(torch, fn):
    """``fn``'s work captured in one CUDA graph; returns its replay.

    For the SSD scan's plain version: at the config's chunk it launches
    more kernels per rep than the card's launch queue holds, so its reps
    cannot be queued behind a spin (``timeit_median_cuda``) one kernel at
    a time.  A graph's replay is one launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator off the graph
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _ssd_route(torch, args, h0, n_sm):
    """The route a call takes and the kernels it launches."""
    from repro_torch.kernels.ssd_scan.ops import ssd_plan

    x, Bm = args[0], args[1]
    if x.dtype != torch.bfloat16:
        return "fp32", "fp32 (1 kernel)"
    plan = ssd_plan(*x.shape, Bm.shape[-1], h0 is not None, n_sm)
    return "tc", (f"tc {plan.route} (chunk {plan.chunk}, {plan.kernels} "
                  f"kernel{'s' if plan.kernels > 1 else ''}, {plan.blocks} "
                  f"blocks, hb={plan.hb} pb={plan.pb})")


def check_ssd(torch):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    from repro_torch.telemetry.timing import timeit_median_cuda

    def ms(fn):
        return timeit_median_cuda(fn) * 1e3

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, failures = [], []
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        el = torch.finfo(dt).bits // 8
        for desc, args, h0 in _ssd_cases(torch, gen, dt):
            kind, route = _ssd_route(torch, args, h0, n_sm)
            n_route = getattr(ssd_scan, f"launches_{kind}")
            y, h = ssd_scan(*args, initial_state=h0)
            if getattr(ssd_scan, f"launches_{kind}") != n_route + 1:
                raise AssertionError(f"ssd_scan {dname} {desc}: did not "
                                     f"launch the {kind} route")
            yp, hp = ssd_scan_plain(*args, initial_state=h0)
            # the same scan in float64: how far each side is from exact
            y64, _ = ssd_scan_plain(*(a.double() for a in args),
                                    initial_state=(None if h0 is None
                                                   else h0.double()))
            torch.cuda.synchronize()
            errs = []  # every shape prints before a failure is raised
            for what, out, ref, tol in (("y", y, yp, SSD_Y_TOL[dname]),
                                        ("state", h, hp, TOL["float32"])):
                try:
                    errs.append(_check(torch, f"ssd_scan {what}", out, ref,
                                       dname, f"{dname} {desc}", tol))
                except AssertionError as e:
                    failures.append(str(e))
                    errs.append(float((out.float() - ref.float()).abs()
                                      .max()))
            f64 = [float((v.double() - y64).abs().max()) for v in (y, yp)]
            del y64
            bytes_, flops = _ssd_work(args[0], args[1].shape[-1], el,
                                      h0 is not None)
            row = dict(shape=desc, dtype=dname, route=route,
                       max_abs_err=errs[0], state_err=errs[1], f64_err=f64,
                       ms=ms(lambda: ssd_scan(*args, initial_state=h0)),
                       plain_ms=ms(_graphed(torch, lambda: ssd_scan_plain(
                           *args, initial_state=h0))),
                       library_ms=None)
            row["bound_ms"], row["bound_by"] = _bound(dname, bytes_, flops)
            rows.append(row)
            print(f"[kernel] ssd_scan {dname} {desc} ({route}): "
                  f"max_abs_err={errs[0]!r} state_err={errs[1]!r} "
                  f"(atol, rtol {SSD_Y_TOL[dname]}; state {TOL['float32']}) "
                  f"y vs float64: kernel {f64[0]!r} plain {f64[1]!r} "
                  f"ms={row['ms']!r} plain_ms={row['plain_ms']!r} (CUDA "
                  f"graph) library_ms=None bound_ms={row['bound_ms']!r} "
                  f"({row['bound_by']})")
    if failures:
        raise AssertionError("; ".join(failures))
    return rows


def _busy_us(kernels, ranges):
    """Device microseconds of ``kernels`` inside ``ranges``: both sorted
    lists of (start, end) on the profiler's clock, the ranges disjoint."""
    import bisect

    starts = [r[0] for r in ranges]
    busy = 0.0
    for k0, k1 in kernels:
        i = bisect.bisect_right(starts, k0) - 1
        for r0, r1 in ranges[max(i, 0):i + 2]:
            busy += max(0.0, min(k1, r1) - max(k0, r0))
    return busy


def _zero_counts():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    decode_attention.launches = prefill_attention.launches = 0
    prefill_attention.launches_tc = prefill_attention.launches_fp32 = 0
    ssd_scan.launches = 0
    decode_attention.routes.clear()


def _counts():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"decode_attention": decode_attention.launches,
            "prefill_attention": prefill_attention.launches,
            "ssd_scan": ssd_scan.launches}


def _b1_routes():
    """B1's launches since the counts were zeroed, by dtype and plan."""
    from repro_torch.kernels.decode_attention.ops import decode_attention

    return "; ".join(
        f"{n} x {dt} cluster={p.n_split} split_len={p.split_len} kw={p.kw} "
        f"gc={p.gc} blocks={p.blocks}"
        for (dt, p), n in sorted(decode_attention.routes.items(),
                                 key=lambda kv: -kv[1]))


def run_serving(torch, arch):
    """The serving path at full width: ``arch`` through ``serve``.

    ``torch.profiler`` records iterations ``PROFILE_FROM`` to
    ``PROFILE_FROM + PROFILE_N - 1`` of this same run (the first are
    warm-up; all of them would be millions of events).  Each engine step
    in that window is a range, ``iteration.mixed`` or ``iteration.solo``:
    the device time of the kernels inside a kind's ranges, over the
    ranges' host wall, is the card's busy share there.  The run's host
    wall per iteration (``iter_wall``) is printed for the iterations
    outside the window, which neither the profiler nor its start and
    stop slow.  Returns the metrics and the run's kernel launches (the
    counts are zeroed just before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import ServerEngine

    cfg = get_config(arch)
    n_req = 24
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {"modes": [], "wall": 0.0}
    engine_step = ServerEngine.step

    def step(self):  # the engine's step, with the profiler's window
        if len(window["modes"]) == PROFILE_FROM:
            torch.cuda.synchronize()
            prof.start()
            window["wall"] = -time.perf_counter()
        mode = "mixed" if self.has_prefill else "solo"
        with record_function(f"iteration.{mode}"):
            res = engine_step(self)
        window["modes"].append(mode)
        if len(window["modes"]) == PROFILE_FROM + PROFILE_N:
            torch.cuda.synchronize()
            window["wall"] += time.perf_counter()
            prof.stop()
        return res

    _zero_counts()
    ServerEngine.step = step
    try:
        t0 = time.perf_counter()
        m = serve(cfg, servers=4, requests=n_req, batch_cap=4, chunk=16,
                  rate=2.0, seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ServerEngine.step = engine_step
    launches = _counts()
    mixer = (f"H={cfg.attn.n_heads} KV={cfg.attn.n_kv_heads} "
             f"D={cfg.attn.head_dim}" if cfg.attn is not None else
             f"N={cfg.ssm.d_state} P={cfg.ssm.head_dim}")
    print(f"[serve] {arch} (layers={cfg.n_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {mixer}) served in {wall:.1f} s; "
          f"launches {launches}")
    if launches["decode_attention"]:
        print(f"[serve] {arch} decode_attention routes: {_b1_routes()}")
    print(f"[serve] summary {json.dumps(m.summary(), sort_keys=True)}")
    modes = window["modes"]
    for mode, ts in m.iter_wall.items():
        # this mode's iterations inside the profiled window
        skip = {modes[:i].count(mode) for i in
                range(PROFILE_FROM, PROFILE_FROM + PROFILE_N)
                if modes[i] == mode}
        ts = [t for j, t in enumerate(ts) if j not in skip]
        srt = sorted(ts)
        print(f"[serve] {mode} iterations: {len(ts) + len(skip)}; the "
              f"{len(ts)} unprofiled: host wall ms mean "
              f"{1e3 * sum(ts) / max(len(ts), 1)!r} median "
              f"{1e3 * srt[len(srt) // 2] if ts else float('nan')!r} "
              f"first {1e3 * ts[0] if ts else float('nan')!r}")
    if not (m.completions == m.arrivals == n_req):
        raise AssertionError(f"serving {arch}: {m.completions} of "
                             f"{m.arrivals} requests completed, expected "
                             f"{n_req}")

    # the ranges appear twice: on the host, and on the device as the span
    # of their kernels
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("iteration.")]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device)
    total = sum(k1 - k0 for k0, k1 in kernels)
    print(f"[serve] profiled iterations {PROFILE_FROM}-"
          f"{PROFILE_FROM + PROFILE_N - 1} of this run: {len(kernels)} device "
          f"events, {total / 1e3!r} device ms in {1e3 * window['wall']!r} ms "
          f"of host wall: device idle {1 - total / 1e6 / window['wall']!r}")
    for mode in ("mixed", "solo"):
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in events if e.name == f"iteration.{mode}"
                        and e.device_type == DeviceType.CPU)
        if not ranges:
            raise AssertionError(f"serving {arch}: no {mode} iteration in "
                                 f"the profiled window")
        busy = _busy_us(kernels, ranges)
        span = sum(r1 - r0 for r0, r1 in ranges)
        print(f"[serve] profiled {mode} iterations: {len(ranges)}, host wall "
              f"ms mean {span / 1e3 / len(ranges)!r}, device busy ms mean "
              f"{busy / 1e3 / len(ranges)!r}: device idle {1 - busy / span!r}")
    by_kernel = {}
    for e in device:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
            + e.time_range.end - e.time_range.start
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    print("[serve] profiled window's top device time (ms per iteration): "
          + ", ".join(f"{k[:48]} {v / 1e3 / PROFILE_N:.4f}" for k, v in top))
    return m, launches


def check_model_outputs(torch):
    """A whole-prompt prefill at full width; reduced mamba2 on the card
    against the CPU's plain versions on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    cfg = get_config(SSD_ARCH)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    B, S = 4, 2048
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    caches = M.init_cache(cfg, B, S, torch.float32, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = M.forward_prefill(cfg, params, toks, pos, caches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if logits.shape != (B, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits.float()).all()) \
            or not bool(torch.isfinite(caches[0]["b0"]["ssm"]).all()):
        raise AssertionError(f"prefill B={B} S={S}: bad logits "
                             f"{tuple(logits.shape)} or non-finite values")
    print(f"[serve] forward_prefill B={B} S={S} at full width: "
          f"{1e3 * wall!r} ms (host wall, first call), logits finite")
    del caches

    small = get_config(SSD_ARCH, reduced=True)
    p_cpu = M.init_model(small, torch.Generator().manual_seed(0),
                         device="cpu")
    t = torch.randint(0, small.vocab_size, (2, 64),
                      generator=torch.Generator().manual_seed(3),
                      dtype=torch.int32)
    ps = torch.arange(64, dtype=torch.int32)[None].expand(2, 64)
    outs = []
    for dev in ("cpu", "cuda"):
        lg, cs = M.forward_prefill(
            small, tree_map(lambda a: a.to(dev), p_cpu), t.to(dev),
            ps.to(dev), M.init_cache(small, 2, 128, torch.float32, dev))
        outs.append((lg.cpu(), cs[0]["b0"]["ssm"].cpu()))
    errs = [float((a - b).abs().max()) for a, b in zip(*outs)]
    for (a, b), err in zip(zip(*outs), errs):
        if not bool(((a - b).abs() <= 1e-4 + 1e-4 * a.abs()).all()):
            raise AssertionError(f"reduced {SSD_ARCH}: card vs CPU max abs "
                                 f"err {err} beyond 1e-4")
    print(f"[serve] reduced {SSD_ARCH} on the card matches the CPU: logits "
          f"max abs err {errs[0]!r}, state {errs[1]!r}")


def _n_attn(cfg) -> int:
    return sum(s.mixer in ("attn", "attn_local") for s in cfg.block_specs())


def _whole_prompt(torch, arch, B, S, steps):
    """``arch`` at its published width and depth (random f32 weights,
    seed 0): a whole-prompt ``forward_prefill(kernel_impl="pallas")`` with
    bf16 caches, then ``steps`` decodes on them.  Every attention layer
    must run B2 on its tensor-core route and B1 on its bf16 route, and
    the logits must be finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.models import model as M
    from repro_torch.models.config import segment_layers

    cfg = get_config(arch)
    n_attn = _n_attn(cfg)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    caches = M.init_cache(cfg, B, S + steps, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = M.forward_prefill(cfg, params, toks, pos, caches,
                                       kernel_impl="pallas")
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    if prefill_attention.launches_tc != n_attn \
            or prefill_attention.launches != n_attn:
        raise AssertionError(f"{arch} prefill: B2 launched "
                             f"{prefill_attention.launches} times, "
                             f"{prefill_attention.launches_tc} on the "
                             f"tensor-core route; expected {n_attn}")
    t0 = time.perf_counter()
    for i in range(steps):
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        logits, caches = M.forward_decode(
            cfg, params, nxt,
            torch.full((B,), S + i, dtype=torch.int32, device="cuda"),
            caches)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / steps
    bf16 = sum(n for (dt, _), n in decode_attention.routes.items()
               if dt == "bfloat16")
    if decode_attention.launches != steps * n_attn or bf16 != steps * n_attn:
        raise AssertionError(f"{arch} decode: B1 launched "
                             f"{decode_attention.launches} times ({bf16} "
                             f"bf16); expected {steps} x {n_attn}")
    if logits.shape != (B, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{arch} B={B} S={S}: bad logits "
                             f"{tuple(logits.shape)} or non-finite values")
    ring = ""
    local = [seg[f"b{i}"]["pos"] for seg, (block, _) in
             zip(caches, segment_layers(cfg.block_specs()))
             for i, spec in enumerate(block) if spec.mixer == "attn_local"]
    if local:
        lo, hi = int(local[0].min()), int(local[0].max())
        if not (hi == S + steps - 1 and lo == S + steps - local[0].shape[-1]):
            raise AssertionError(f"{arch}: the local ring holds positions "
                                 f"{lo}..{hi}, expected the last "
                                 f"{local[0].shape[-1]} of {S + steps}")
        ring = (f"; local ring of {local[0].shape[-1]} wrapped, holds "
                f"positions {lo}..{hi}")
    print(f"[attn] {arch} (layers={cfg.n_layers}, {n_attn} attention, "
          f"d_model={cfg.d_model} H={cfg.attn.n_heads} "
          f"KV={cfg.attn.n_kv_heads} D={cfg.attn.head_dim} vocab="
          f"{cfg.vocab_size}) forward_prefill(kernel_impl='pallas') B={B} "
          f"S={S}, bf16 caches: {1e3 * t_pf!r} ms host wall (first call), "
          f"B2 {prefill_attention.launches_tc} launches on the tensor-core "
          f"route; {steps} decodes {1e3 * t_dec!r} ms each (host wall), "
          f"B1 routes: {_b1_routes()}; logits finite{ring}")
    return _counts()


def check_attention_outputs(torch):
    """Whole-prompt prefill and decode at full width (qwen2-0.5b, gemma2-2b
    past its window); reduced attention models on the card against the
    CPU's plain versions on the same weights.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    total = {}
    for arch, B, S, steps in (("qwen2-0.5b", 4, 2048, 16),
                              ("gemma2-2b", 1, 4608, 4)):
        _zero_counts()
        for k, n in _whole_prompt(torch, arch, B, S, steps).items():
            total[k] = total.get(k, 0) + n
        torch.cuda.empty_cache()

    # reduced configs (window 32): a whole prefill (B2), two continuation
    # chunks, 8 decodes (B1), the rings wrapped
    for arch in ("qwen2-0.5b", "gemma2-2b", "recurrentgemma-2b"):
        small = get_config(arch, reduced=True)
        p_cpu = M.init_model(small, torch.Generator().manual_seed(0),
                             device="cpu")
        rng = torch.Generator().manual_seed(3)
        calls = [(torch.randint(0, small.vocab_size, (2, 40), generator=rng,
                                dtype=torch.int32), 0, False)]
        calls += [(torch.randint(0, small.vocab_size, (2, 16), generator=rng,
                                 dtype=torch.int32), p0, True)
                  for p0 in (40, 56)]
        calls += [(torch.randint(0, small.vocab_size, (2, 1), generator=rng,
                                 dtype=torch.int32), 72 + i, None)
                  for i in range(8)]
        outs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), p_cpu)
            caches = M.init_cache(small, 2, 96, torch.float32, dev)
            outs[dev] = []
            for toks, p0, cont in calls:
                t = toks.to(dev)
                if cont is None:
                    lg, caches = M.forward_decode(
                        small, p, t, torch.full((2,), p0, dtype=torch.int32,
                                                device=dev), caches)
                else:
                    pos = (p0 + torch.arange(t.shape[1], dtype=torch.int32,
                                             device=dev))[None].expand(2, -1)
                    lg, caches = M.forward_prefill(
                        small, p, t, pos, caches, kernel_impl="pallas",
                        continuation=cont)
                outs[dev].append(lg.cpu())
        err = max(float((a - b).abs().max())
                  for a, b in zip(outs["cpu"], outs["cuda"]))
        for a, b in zip(outs["cpu"], outs["cuda"]):
            if not bool(((a - b).abs() <= 1e-4 + 1e-4 * a.abs()).all()):
                raise AssertionError(f"reduced {arch}: card vs CPU max abs "
                                     f"err {err} beyond 1e-4")
        print(f"[attn] reduced {arch} on the card matches the CPU over a "
              f"whole prefill, 2 continuation chunks and 8 decodes: logits "
              f"max abs err {err!r}")
    return total


def run_loop(backend: str):
    """The calibrated control loop through the port's public API."""
    from repro_torch.calibration import (CalibrationGrid, calibrate,
                                         model_from_artifact)
    from repro_torch.calibration.models import AffineModel
    from repro_torch.core.planning import SLISpec, solve_bundled_lp
    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import Pricing, WorkloadClass
    from repro_torch.data.traces import (TraceConfig, synth_azure_trace,
                                         trace_class_means)
    from repro_torch.serving.engine_sim import ClusterEngine, EngineConfig

    art = calibrate(ARCH, backend=backend, grid=CalibrationGrid.default())
    trace = synth_azure_trace(TraceConfig(horizon=HORIZON, base_rate=2.0,
                                          compression=0.08, seed=42))
    means = trace_class_means(trace, 2)
    classes = [WorkloadClass(nm, m[0], m[1], m[2] / N_SERVERS, patience=3e-4)
               for nm, m in zip(("code", "conv"), means)]
    pricing = Pricing(c_p=0.1, c_d=0.2)
    revenue = {}
    for label, model in (("seed", AffineModel()),
                         ("fitted", model_from_artifact(art, "fitted"))):
        prim = model.primitives()
        plan = solve_bundled_lp(classes, prim, pricing,
                                sli=SLISpec(pin_zero_decode_queue=True))
        cfg = EngineConfig(prim=prim, pricing=pricing, n_servers=N_SERVERS,
                           iter_model=model)
        m = ClusterEngine(classes, gate_and_route(plan), cfg).run(trace,
                                                                   HORIZON)
        revenue[label] = m.revenue_rate()
        if not (math.isfinite(revenue[label]) and revenue[label] > 0
                and m.completions > 0):
            raise AssertionError(f"{backend} loop, {label} model: revenue "
                                 f"{revenue[label]}, {m.completions} done")
    return art, revenue


def _wall_ms(torch, fn, reps=5):
    """Median host wall of ``fn`` between two synchronizes, in ms: for a
    wrapper that reads a count back from the card between its launches,
    which the spin-queued timer cannot take."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * sorted(times)[len(times) // 2]


def _ctmc_bound(raws, steps):
    """(ms, by) of a ctmc_scan call returning the carries ``raws`` (float64,
    two classes): each input (a parameter block of 16 I + 7 floats and 8
    ints a replication) read and each output written once, against the
    FP64 operations of the ``steps`` the replications took."""
    R = sum(int(r["t"].shape[0]) for r in raws)
    bytes_ = R * (8 * (16 * 2 + 7) + 8 * 8) + 8 * sum(
        v.numel() for r in raws for v in r.values())
    t_bytes = bytes_ / HBM_BW
    t_ops = CTMC_FLOPS_PER_STEP[2] * steps / PEAK_FP64
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def check_optimality_gap(torch):
    """Phase 7: the planner, ctmc_scan against its plain version, the gap
    at n=16 and n=65536 in one launch, and the fluid's steady state.
    Returns ctmc_scan's row for the kernels line."""
    import numpy as np

    from repro_torch.core.ctmc_jax import UniformizedCTMC, run_cells_raw
    from repro_torch.core.fluid import fluid_steady_state
    from repro_torch.core.planning import solve_bundled_lp, solve_separate_lp
    from repro_torch.core.planning_batch import solve_plan_batch
    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import (Pricing, ServicePrimitives,
                                        WorkloadClass)
    from repro_torch.kernels.ctmc_scan import ops as ctmc_ops
    from repro_torch.kernels.ctmc_scan.ops import (ctmc_scan,
                                                   ctmc_scan_plain,
                                                   pack_block)

    art = json.loads(GAP_ARTIFACT.read_text())
    ref = {(r["scheme"], r["n"]): r for r in art["rows"]}
    classes = [WorkloadClass(nm, p, d, arrival_rate=lam, patience=th)
               for nm, p, d, lam, th in GAP_CLASSES]
    prim, pricing = ServicePrimitives(), Pricing()
    plans = {"bundled": solve_bundled_lp(classes, prim, pricing),
             "separate": solve_separate_lp(classes, prim, pricing)}
    policies = {"bundled": gate_and_route(plans["bundled"]),
                "separate": gate_and_route(
                    plans["separate"], name="gate_and_route_separate"
                ).replace(charging="separate")}

    # -- R* and the batched planner on the card
    for scheme, plan in plans.items():
        want = ref[(scheme, 16)]["R_star"]
        if round(plan.revenue_rate, 3) != want:
            raise AssertionError(f"{scheme} R* {plan.revenue_rate!r} is not "
                                 f"the artifact's {want}")
        t0 = time.perf_counter()
        pb = solve_plan_batch([classes], prim, pricing, objective=scheme)
        wall = time.perf_counter() - t0
        r_jax = float(pb.revenue_rate[0])
        agree = abs(plan.revenue_rate - r_jax) / (1.0 + abs(plan.revenue_rate))
        print(f"[gap] {scheme}: R* simplex {plan.revenue_rate!r}, "
              f"solve_plan_batch on the card {r_jax!r} (converged "
              f"{bool(pb.converged[0])}, {int(pb.n_iter[0])} iterations, "
              f"{1e3 * wall:.1f} ms host wall): relative {agree:.3e} "
              f"(artifact {art['r_star_agreement_rel']:.3e})")
        if not bool(pb.converged.all()) or agree > LP_AGREE:
            raise AssertionError(f"{scheme}: solve_plan_batch gave "
                                 f"{r_jax!r}, relative {agree} > {LP_AGREE}")

    # -- ctmc_scan against its plain version: n=16 (8 seeds, horizon 40)
    # and n=65536 (2 seeds, horizon 0.03) in one call, as the gap run packs
    # its cells; once in one launch and once in launches of CTMC_RESUME
    # steps, which resume the carry (and the probes) from device memory
    def block(telemetry):
        sims, keys = [], []
        for n, seeds, horizon in CTMC_CHECK:
            for k in (("bundled", "separate") if telemetry is None
                      else ("bundled",)):
                sims.append(UniformizedCTMC(
                    classes, prim, pricing, policies[k], n=n,
                    horizon=horizon, warmup=horizon / 4,
                    dtype=torch.float64, telemetry=telemetry))
                keys.append(torch.stack([torch.tensor([s, 0])
                                         for s in range(seeds)]))
        parts = [pack_block(sim.params, sim._static, kk)
                 for sim, kk in zip(sims, keys)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                sims[0].telemetry.n_bins if telemetry else 0)

    def agree(out, plain, label):
        err = 0.0
        for k, v in plain.items():
            if k in ("t", "rev") or k.startswith("acc"):
                rel = ((out[k] - v).abs() / v.abs().clamp_min(1e-300)).max()
                err = max(err, float((out[k] - v).abs().max()))
                if float(rel) > CTMC_RTOL:
                    raise AssertionError(f"ctmc_scan {label} {k}: relative "
                                         f"{float(rel)} > {CTMC_RTOL}")
            elif not torch.equal(out[k], v):
                raise AssertionError(f"ctmc_scan {label} {k}: a counter "
                                     f"differs from the plain version's")
        return err

    row = None
    for telemetry in (None, True):
        fp, ip, nb = block(telemetry)
        n0 = ctmc_scan.launches
        out = ctmc_scan(fp, ip, n_classes=2, n_bins=nb)
        one = ctmc_scan.launches - n0
        saved, ctmc_ops._BLOCK_STEPS = ctmc_ops._BLOCK_STEPS, CTMC_RESUME
        try:
            n0 = ctmc_scan.launches
            resumed = ctmc_scan(fp, ip, n_classes=2, n_bins=nb)
            many = ctmc_scan.launches - n0
        finally:
            ctmc_ops._BLOCK_STEPS = saved
        if many < 3:
            raise AssertionError(f"ctmc_scan in blocks of {CTMC_RESUME} "
                                 f"steps took {many} launches")
        t0 = time.perf_counter()
        plain = ctmc_scan_plain(fp, ip, n_classes=2, n_bins=nb)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = max(agree(out, plain, f"({one} launch)"),
                  agree(resumed, plain, f"({many} launches)"))
        steps = out["n_events"]
        ms = _wall_ms(torch, lambda: ctmc_scan(fp, ip, n_classes=2,
                                               n_bins=nb))
        bound, by = _ctmc_bound([out], float(steps.sum()))
        desc = (f"n=16 x {CTMC_CHECK[0][1]} horizon {CTMC_CHECK[0][2]} + "
                f"n=65536 x {CTMC_CHECK[1][1]} horizon {CTMC_CHECK[1][2]}, "
                f"{fp.shape[0]} replications float64"
                + (" telemetry" if nb else " both schemes"))
        print(f"[kernel] ctmc_scan {desc}: equal to the plain version in "
              f"{one} launch and in {many} launches of {CTMC_RESUME} steps "
              f"(counters exact, floats max abs err {err!r}); steps per "
              f"replication max {int(steps.max())} mean "
              f"{float(steps.mean())!r}; ms={ms!r} "
              f"({1e6 * ms / float(steps.max())!r} ns per step, "
              f"{float(steps.max()) / ms * 1e3!r} events/s per replication,"
              f" {float(steps.sum()) / ms * 1e3!r} in aggregate) "
              f"plain_ms={plain_ms!r} library_ms=None bound_ms={bound!r} "
              f"({by}; latency-bound: a serial chain of steps)")
        if row is None:
            row = dict(shape=desc, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=by, max_abs_err=err, launches_at_shape=one)

    # -- the gap: both schemes at n=16 and n=65536, in one launch
    cells, keys = [], []
    for n, (seeds, horizon, warmup) in GAP_SCHEDULE.items():
        for scheme in ("bundled", "separate"):
            sim = UniformizedCTMC(classes, prim, pricing, policies[scheme],
                                  n=n, horizon=horizon, warmup=warmup,
                                  dtype=torch.float64)
            cells.append((sim, list(range(seeds))))  # common seeds per n
            keys.append((scheme, n))
    lo, hi = min(GAP_SCHEDULE), max(GAP_SCHEDULE)
    small = [c for c, k in zip(cells, keys) if k[1] == lo]
    t16 = _wall_ms(torch, lambda: run_cells_raw(small), reps=3)
    ctmc_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raws = run_cells_raw(cells)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches = ctmc_scan.launches
    if launches <= 0:
        raise AssertionError("the gap run never launched ctmc_scan")
    total = sum(float(r["n_events"].sum()) for r in raws)
    small_raws = [r for r, k in zip(raws, keys) if k[1] == lo]
    small_total = sum(float(r["n_events"].sum()) for r in small_raws)
    bound, by = _ctmc_bound(raws, total)
    bound_lo, by_lo = _ctmc_bound(small_raws, small_total)
    print(f"[gap] one call of {sum(len(s) for _, s in cells)} replications: "
          f"{launches} launches of ctmc_scan, {wall!r} ms host wall, "
          f"{total!r} events ({total / wall * 1e3!r} events/s in "
          f"aggregate), bound_ms={bound!r} ({by}; latency-bound: a serial "
          f"chain of steps); the n={lo} cells alone (1 launch): {t16!r} ms, "
          f"{small_total!r} events ({small_total / t16 * 1e3!r} events/s in "
          f"aggregate), bound_ms={bound_lo!r} ({by_lo})")
    gaps, failures = {}, []
    for (sim, seeds), raw, (scheme, n) in zip(cells, raws, keys):
        res = sim.results_from_raw(raw)
        if not all(r.t_end == sim.horizon for r in res):
            failures.append(f"{scheme} n={n}: t_end "
                            f"{[r.t_end for r in res]} short of the horizon")
        R = plans[scheme].revenue_rate
        g = np.array([100.0 * (1.0 - r.revenue_rate_per_server / R)
                      for r in res])
        want = ref[(scheme, n)]
        se = max(float(g.std() / np.sqrt(len(g))), want["gap_se"])
        z = (float(g.mean()) - want["gap_pct"]) / math.sqrt(
            se ** 2 + want["gap_se"] ** 2)
        gaps[(scheme, n)] = float(g.mean())
        steps = raw["n_events"]
        t_row = t16 if n == lo else wall
        print(f"[gap] {scheme} n={n}: gap {float(g.mean())!r}% (se "
              f"{float(g.std() / np.sqrt(len(g)))!r}, {len(g)} seeds, horizon"
              f" {sim.horizon}) vs the artifact's {want['gap_pct']}% (se "
              f"{want['gap_se']}): z={z!r}; steps per replication max "
              f"{int(steps.max())} of a budget of {sim.n_steps}; "
              f"{1e6 * t_row / float(steps.max())!r} ns per step, "
              f"{float(steps.max()) / t_row * 1e3!r} events/s per "
              f"replication ({'its own' if n == lo else 'the whole'} call "
              f"{t_row!r} ms)")
        if abs(z) > GAP_Z:
            failures.append(f"{scheme} n={n}: gap {float(g.mean())} is "
                            f"{z:.2f} sigma from the artifact's "
                            f"{want['gap_pct']}")
        if float(g.mean()) < GAP_FLOOR_PCT:
            failures.append(f"{scheme} n={n}: gap {float(g.mean())} below "
                            f"the noise floor {GAP_FLOOR_PCT}")
    for scheme in ("bundled", "separate"):
        if not gaps[(scheme, hi)] < gaps[(scheme, lo)]:
            failures.append(f"{scheme}: the gap does not fall from n={lo} "
                            f"to n={hi}: {gaps}")
    if failures:
        raise AssertionError("; ".join(failures))

    # -- the fluid limit of the bundled plan (tests/test_fluid_ctmc.py)
    plan = plans["bundled"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss = fluid_steady_state(classes, prim, pricing, plan, horizon=300.0,
                            dt=2e-3)
    wall_f = time.perf_counter() - t0
    print(f"[gap] fluid_steady_state (bundled, horizon 300, dt 2e-3, "
          f"150000 eager steps on the card): {wall_f:.2f} s host wall "
          f"({1e6 * wall_f / 150000:.1f} us per step); x {ss['x'].tolist()} "
          f"vs x* {plan.x.tolist()}, revenue {ss['revenue_rate']!r} vs R* "
          f"{plan.revenue_rate!r}, qd {ss['qd'].tolist()}, qp "
          f"{ss['qp'].tolist()} vs {plan.qp.tolist()}")
    if not (np.allclose(ss["x"], plan.x, rtol=0, atol=5e-3)
            and abs(ss["revenue_rate"] - plan.revenue_rate)
            <= 0.02 * plan.revenue_rate
            and bool(np.all(ss["qd"] < 5e-3))
            and np.allclose(ss["qp"], plan.qp, rtol=0, atol=2e-2)):
        raise AssertionError("the fluid's steady state misses the LP")
    row.update(launches=launches, main_ms=wall, main_bound_ms=bound,
               main_bound_by=by, main_shape=(
                   "gap run: " + ", ".join(f"{scheme} n={n} x {len(s)}"
                                           for (_, s), (scheme, n)
                                           in zip(cells, keys))))
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    cap = "".join(map(str, torch.cuda.get_device_capability(0)))
    print(f"[device] {name} (sm_{cap}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        _print_ptxas(lib.name.split("-")[0],
                     log.read_text() if log.exists() else "")

    # 3. kernels vs plain
    t0 = time.perf_counter()
    rows = check_kernels(torch)
    print(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")

    # 3b. SSD scan vs plain
    t0 = time.perf_counter()
    rows["ssd_scan"] = check_ssd(torch)
    print(f"[kernels] ssd_scan checked in {time.perf_counter() - t0:.1f} s")

    # 4. main path
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    t0 = time.perf_counter()
    _zero_counts()
    art, revenue = run_loop("kernels")
    launches = {"decode_attention": decode_attention.launches,
                "prefill_attention": prefill_attention.launches}
    routes = {"tc": prefill_attention.launches_tc,
              "fp32": prefill_attention.launches_fp32}
    print(f"[main] calibrate+plan+replay in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}; prefill_attention by route {routes}")
    if routes["tc"] != launches["prefill_attention"]:
        raise AssertionError(f"the bf16 loop's prefill went off the "
                             f"tensor-core route: {routes}")
    if art.backend != "kernels" or art.hw.get("device") != name:
        raise AssertionError(f"artifact backend {art.backend!r}, device "
                             f"{art.hw.get('device')!r}; expected kernels on "
                             f"{name!r}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {k}")
    print(f"[main] hw {json.dumps(art.hw, sort_keys=True)}")
    print(f"[main] alpha={art.alpha!r} beta={art.beta!r} a_s={art.a_s!r} "
          f"b_s={art.b_s!r} r2_mix={art.mix.r2!r} r2_solo={art.solo.r2!r}")
    for surface, fit in (("tau_mix", art.mix), ("tau_solo", art.solo)):
        if fit.r2 < R2_TRUST:
            print(f"[main] {surface} fit R^2={fit.r2!r} < {R2_TRUST}: the "
                  f"fitted {surface} is not to be trusted")
    print(f"[main] revenue_rate seed={revenue['seed']!r} "
          f"fitted={revenue['fitted']!r}")
    for s in art.samples:
        print(f"[main] sample {s.mode} B={s.batch} C={s.chunk} K={s.kv} "
              f"tau={s.tau!r}")
    _, ref_rev = run_loop("roofline")
    for k, want in REF_ROOFLINE_REVENUE.items():
        if not math.isclose(ref_rev[k], want, rel_tol=1e-9):
            raise AssertionError(f"roofline loop {k} revenue {ref_rev[k]!r} "
                                 f"!= reference {want!r}")
    print(f"[main] roofline loop matches the reference: {ref_rev}")

    # 5. serving path
    t0 = time.perf_counter()
    ssm_cfg = get_config(SSD_ARCH)
    m, served = run_serving(torch, SSD_ARCH)
    n_mix = len(m.iter_wall["mixed"])
    if n_mix == 0 or served["ssd_scan"] < ssm_cfg.n_layers * n_mix:
        raise AssertionError(f"serving: ssd_scan launched "
                             f"{served['ssd_scan']} times for {n_mix} prefill "
                             f"chunks x {ssm_cfg.n_layers} SSM layers")
    launches["ssd_scan"] = served["ssd_scan"]
    check_model_outputs(torch)
    print(f"[serve] phase 5 in {time.perf_counter() - t0:.1f} s")

    # 6. attention serving path
    t0 = time.perf_counter()
    attn_cfg = get_config(ARCH)
    m, served = run_serving(torch, ARCH)
    iters = len(m.iter_wall["mixed"]) + len(m.iter_wall["solo"])
    if served["decode_attention"] != _n_attn(attn_cfg) * iters:
        raise AssertionError(f"serving {ARCH}: decode_attention launched "
                             f"{served['decode_attention']} times for "
                             f"{iters} iterations x {_n_attn(attn_cfg)} "
                             f"attention layers")
    print(f"[attn] {ARCH} serving: {iters} iterations x "
          f"{_n_attn(attn_cfg)} attention layers = "
          f"{served['decode_attention']} B1 launches")
    more = check_attention_outputs(torch)
    for k in ("decode_attention", "prefill_attention"):
        n = served[k] + more[k]
        if n <= 0:
            raise AssertionError(f"phase 6 never launched {k}")
        launches[k] += n
    print(f"[attn] phase 6 in {time.perf_counter() - t0:.1f} s")

    # 7. optimality gap
    t0 = time.perf_counter()
    gap_row = check_optimality_gap(torch)
    print(f"[gap] phase 7 in {time.perf_counter() - t0:.1f} s")

    # the main path's largest shape per kernel stands for it in the line
    main_shape = {"decode_attention": "B=16 S=512 main",
                  "prefill_attention": "C=512 causal main",
                  "ssd_scan": "B=1 S=16 H=24 engine chunk"}
    sources = {"decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:79"),
        "prefill_attention": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention/kernel.py:93"),
        "ssd_scan": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:68")}
    line = []
    for k, rs in rows.items():
        r = next(r for r in rs if r["shape"] == main_shape[k]
                 and r["dtype"] == "bfloat16")
        line.append({"name": k, "route": "cuda", "source": sources[k][0],
                     "replaces": sources[k][1], "launches": launches[k],
                     "max_abs_err": max(x["max_abs_err"] for x in rs),
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "shape": f"{r['shape']} bf16"})
    line.append({"name": "ctmc_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ctmc_scan.cu",
                 "replaces": "src/repro/core/ctmc_jax.py:396",
                 "launches": gap_row["launches"],
                 "max_abs_err": gap_row["max_abs_err"], "ms": gap_row["ms"],
                 "plain_ms": gap_row["plain_ms"],
                 "bound_ms": gap_row["bound_ms"],
                 "bound_by": gap_row["bound_by"], "library_ms": None,
                 "shape": gap_row["shape"],
                 # ms and bound above are the check call's; the main path's
                 # own call (the gap run, whose launches are counted):
                 "launches_at_shape": gap_row["launches_at_shape"],
                 "main_shape": gap_row["main_shape"],
                 "main_ms": gap_row["main_ms"],
                 "main_bound_ms": gap_row["main_bound_ms"],
                 "main_bound_by": gap_row["main_bound_by"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
