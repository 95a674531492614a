#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device -- a CUDA card must be visible; prints its name and power limit
   as ``nvidia-smi`` reports them;
2. build -- compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints ``ptxas``'s resource
   report;
3. kernels vs plain -- calls each kernel's wrapper on the card at the
   shapes the calibration loop gives it (bf16 and f32), at odd and masked
   shapes, and at one large shape per kernel, and holds each result to the
   kernel's plain PyTorch version on the same inputs (``TOL``).  Prints,
   per shape: max error, kernel ms, plain ms, ``scaled_dot_product_attention``
   ms (a yardstick the port never calls), each the device time that
   ``timeit_median_cuda`` gives, as the calibration measures it, and the
   bound: the larger of the bytes the function must move over 3.35 TB/s
   and its FLOPs over the peak rate of its type (989 TFLOP/s bf16
   tensor-core, 67 TFLOP/s f32), the H100 SXM data sheet;
4. main path -- the paper's calibrated control loop for qwen2-0.5b at its
   published width, through the port's public API: ``calibrate`` on the
   kernels backend over the default grid, the fitted and seed
   iteration-time models, the bundled planning LP, gate-and-route, and a
   ``ClusterEngine`` replay of the Azure-like trace on 10 servers.  The
   kernel launch counters are zeroed just before and read just after; each
   kernel must have launched.  A fitted surface with R^2 below 0.95 is
   printed as not to be trusted.  The same loop on the deterministic
   roofline backend must reproduce the JAX reference's revenue rates.

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
R2_TRUST = 0.95  # PERF.md section 2: the limit for trusting a fitted surface
# The JAX reference's revenue rates for this loop on the roofline backend
# (repro.calibration + repro.serving.engine_sim.ClusterEngine, seed
# constants and fitted model); the port reproduces them bit for bit on the
# CPU (tests/test_torch_loop.py).
REF_ROOFLINE_REVENUE = {"seed": 2564.921648134311,
                        "fitted": 3087.8527206313215}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _bound(dtype_name: str, bytes_: float, flops: float):
    t_bytes, t_ops = bytes_ / HBM_BW, flops / PEAK[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _check(torch, name, out, ref, dtype_name, shape_desc):
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name} {shape_desc}: bad output "
                             f"{tuple(out.shape)} vs {tuple(ref.shape)}")
    err = (out.float() - ref.float()).abs()
    atol, rtol = TOL[dtype_name]
    if not bool((err <= atol + rtol * ref.float().abs()).all()):
        raise AssertionError(f"{name} {shape_desc}: max abs err "
                             f"{err.max().item()} beyond atol {atol} + rtol "
                             f"{rtol} x |plain|")
    return err.max().item()


def _decode_cases(torch, gen, dt):
    """(description, args, kwargs, kv tokens read) of every decode check."""
    H, KV, D = 14, 2, 64
    cases = []

    def make(B, S, kv_len, **kw):
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
    if dt == torch.bfloat16:
        args, kw = make(64, 4096, [4096] * 64)
        cases.append(("B=64 S=4096 large", args, kw, 64 * 4096))
    return H, KV, D, cases


def _prefill_cases(torch, gen, dt):
    H, KV, D = 14, 2, 64
    cases = []

    def make(S, **kw):
        q = torch.randn(1, S, H, D, generator=gen, device="cuda", dtype=dt)
        k = torch.randn(1, S, KV, D, generator=gen, device="cuda", dtype=dt)
        v = torch.randn(1, S, KV, D, generator=gen, device="cuda", dtype=dt)
        return (q, k, v), kw

    for C in (32, 64, 128, 256, 512):  # the calibration grid's chunks
        cases.append((f"C={C} causal main", *make(C)))
    for C in (17, 48, 100, 300):
        cases.append((f"C={C} non-causal", *make(C, causal=False)))
    cases.append(("C=200 window=96", *make(200, window=96)))
    cases.append(("C=200 prefix=64", *make(200, prefix_len=64)))
    cases.append(("C=200 softcap=50", *make(200, attn_softcap=50.0)))
    if dt == torch.bfloat16:
        cases.append(("C=4096 causal large", *make(4096)))
    return H, KV, D, cases


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
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.prefill_attention.ops import (
        prefill_attention, prefill_attention_plain)
    from repro_torch.telemetry.timing import timeit_median_cuda

    def ms(fn):
        return timeit_median_cuda(fn) * 1e3

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"decode_attention": [], "prefill_attention": []}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        el = torch.finfo(dt).bits // 8

        H, KV, D, cases = _decode_cases(torch, gen, dt)
        for desc, (q, k, v, kl), kw, kv_read in cases:
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
            row = dict(shape=desc, dtype=dname, max_abs_err=err,
                       ms=ms(lambda: decode_attention(q, k, v, kl, **kw)),
                       plain_ms=ms(lambda: decode_attention_plain(
                           q, k, v, kl, **kw)),
                       library_ms=lib)
            row["bound_ms"], row["bound_by"] = _bound(dname, bytes_, flops)
            rows["decode_attention"].append(row)

        H, KV, D, cases = _prefill_cases(torch, gen, dt)
        for desc, (q, k, v), kw in cases:
            out = prefill_attention(q, k, v, **kw)
            ref = prefill_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = _check(torch, "prefill_attention", out, ref, dname, desc)
            S = q.shape[1]
            pairs = _pairs(torch, S, kw.get("causal", True), kw.get("window"),
                           kw.get("prefix_len"))
            bytes_ = (2 * S * H * D + 2 * S * KV * D) * el
            flops = 4.0 * pairs * H * D
            lib = None
            if set(kw) <= {"causal"}:
                lib = ms(_sdpa(torch, q, k, v,
                               is_causal=kw.get("causal", True)))
            row = dict(shape=desc, dtype=dname, max_abs_err=err,
                       ms=ms(lambda: prefill_attention(q, k, v, **kw)),
                       plain_ms=ms(lambda: prefill_attention_plain(
                           q, k, v, **kw)),
                       library_ms=lib)
            row["bound_ms"], row["bound_by"] = _bound(dname, bytes_, flops)
            rows["prefill_attention"].append(row)

    for name, rs in rows.items():
        for r in rs:
            print(f"[kernel] {name} {r['dtype']} {r['shape']}: "
                  f"max_abs_err={r['max_abs_err']!r} "
                  f"(atol, rtol {TOL[r['dtype']]}) ms={r['ms']!r} "
                  f"plain_ms={r['plain_ms']!r} "
                  f"library_ms={r['library_ms']!r} bound_ms={r['bound_ms']!r} "
                  f"({r['bound_by']})")
    return rows


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
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {lib.name.split('-')[0]}: {line.strip()}")

    # 3. kernels vs plain
    t0 = time.perf_counter()
    rows = check_kernels(torch)
    print(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")

    # 4. main path
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    t0 = time.perf_counter()
    decode_attention.launches = 0
    prefill_attention.launches = 0
    art, revenue = run_loop("kernels")
    launches = {"decode_attention": decode_attention.launches,
                "prefill_attention": prefill_attention.launches}
    print(f"[main] calibrate+plan+replay in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
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

    # the main path's largest shape per kernel stands for it in the line
    main_shape = {"decode_attention": "B=16 S=512 main",
                  "prefill_attention": "C=512 causal main"}
    sources = {"decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:79"),
        "prefill_attention": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention/kernel.py:93")}
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
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
