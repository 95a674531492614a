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
   B=4 S=2048), at the grok cells' chunk (B2 with a query offset and a
   key length read on the card: 512 queries, 48 heads over 8, D=128,
   softcap 30, over one slot of an (8, 8192, 8, 128) cache ending at
   512, 2048, 6144 and 8192 keys, NaN past the end), at odd and masked
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
   tensor-core, 67 TFLOP/s f32), the H100 SXM data sheet.  B4, MLA's
   latent attention, at the DeepSeek-V3 cell's widths (128 heads, 512 +
   64): its decode (64 rows over their own 8192 slots, lengths spread
   over 1..8192) and its chunk (512 queries over one slot ending at 512,
   2048, 6144 and 8192 keys, and at 2048 from position 0), NaN past each
   end, held to the plain version as the card tests hold it
   (``tests/mla_tolerance.py``); its route is its split into pieces, and
   SDPA, which takes no 576-wide key beside a 512-wide value, gives no
   time;
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
   dt 2e-3; the Euler loop replays a CUDA graph of K steps between
   record points) must reach the LP as
   ``tests/test_fluid_ctmc.py`` requires.  Prints each row's z-score,
   steps, time and events/s.
8. trace-replay engines (``[engine]`` lines) -- the batched
   ``ClusterEngineJAX`` (its step captured in CUDA graphs of
   ``BLOCK_STEPS`` steps) at ``benchmarks/bench_engine_speed.py``'s full
   instance (10 servers, 5825 requests, horizon 60, 32 replications in
   one call, float32): the legacy leg (one event a step) and the hot leg
   (fast-forward) must give the artifact's events and iterations exactly
   and its revenue rate within 1e-5 (``ES_REF``), with no budget
   exhausted; the hot leg runs again with telemetry.  Prints each leg's
   wall (median of 3 after a warm-up that captures), loop steps, graph
   replays, ns a loop step, events/s and the byte bound, and, for the
   two legs without telemetry, the card's busy time a loop step, the
   set-up of a call excluded (``_engine_busy``), and its idle share
   against the leg's wall a loop step; the
   telemetry overhead comes from hot and hot+telemetry runs taken in
   turn (median of the pairwise ratios and their range).  The five
   policies of
   ``tests/test_engine_diff.py::_mk(seed=42)`` on the card must equal
   the port's CPU route (worker processes started at the phase's start):
   lifecycle codes, counts and cursors exactly, times and revenue within
   1e-5; the randomized router draws the same Philox bits on both.  The
   streamed replay on the card must equal the drain-mode batch replay at
   ``test_stream_matches_batch``'s instance (two segments or more), and
   a ``ScenarioStream``-fed azure_2023 stream (48 servers, rate x20,
   window 8192, chunks of 2048, horizon 300) must end with no budget
   exhausted; prints its requests, segments, window peak and events/s.

9. sweep, fleet and closed loop (``[sweep]`` lines) -- through the
   port's public entry points, at the benchmarks' own sizes: (a)
   ``run_sweep`` over ``ctmc_jax`` at bench_heterogeneity's control
   (n=16, 32 seeds, horizon 300, warmup 75, float64, common random
   numbers; ``ctmc_scan``'s count zeroed just before and read just
   after): every cell at its horizon, the mean gap within 1 point of the
   committed 6.92%, and the ``shard_map`` (tiles of 8) and ``single``
   placements bit for bit the ``vmap`` cells; (b) ``plan_fleet`` on the
   card: a one-class paper-a100 fleet equal to ``solve_plan_jax``
   exactly, and bench_heterogeneity's four fleets at the artifact's R*
   to 3 decimals; (c) bench_sensitivity's 140-point LP grid through
   ``lp`` and ``lp_jax``, revenues within 1e-6, all converged; (d) the
   ``fluid`` evaluator over two_class x {gate_and_route, sli_aware}
   (150 000 graphed Euler steps each), equal to solo
   ``fluid_final_state`` runs within 1e-6 and at the reference's values;
   (e) ``python -m repro_torch.sweep.run`` (called in this process)
   replaying rate_shift and azure_2023 x {gate_and_route, vllm} at n=8,
   8 seeds, horizon 300, fast-forward: no budget exhausted, one cell
   equal to the CPU route (a worker process), the run record passing
   ``python -m repro_torch.telemetry validate-manifest``; (f)
   ``compare_policies`` on rate_shift (8 servers), replayed in worker
   processes: the adaptive lead exactly 5.374133740330568 with the
   simplex plans and within 1e-6 with ``plans_for_scenarios`` solved on
   the card, and the adaptive run's Chrome trace valid.  Prints each
   item's wall, (a)'s events/s and ns an event, (e)'s loop steps and
   graph captures, with the card's name and power limit.
10. the rest of the data plane (``[a10]`` lines) -- prefix-LM, the
   encoder with cross-attention, MLA and the capacity-dispatch MoE, at
   the published widths of paligemma-3b, whisper-base, grok-1-314b (2 of
   its 64 layers) and deepseek-v3-671b (4 of 61: 3 dense, 1 MoE), the
   depth cut only where one card forces it, weights drawn on the card in
   the config's ``param_dtype`` (bf16 but for whisper's f32), one model
   at a time.  (a) B1 and B2 against their plain versions, as in phase 3,
   at the shapes these models give them: B1 at B=4 S=256 for paligemma
   (H=8 KV=1 D=256, bf16 and f32), grok-1 (H=48 KV=8 D=128) and whisper
   (H=KV=8 D=64); B2 on its tensor-core route at paligemma's B=4 S=768
   with ``prefix_len=256`` (SDPA with the explicit mask for the library
   time), grok-1's B=4 S=2048 and whisper's B=4 S=448.  (b) paligemma
   (text only, as the engine serves it), grok-1, deepseek-v3 and
   recurrentgemma-2b through ``serve`` (4 servers, batch cap 4, chunk
   16, the two classes, f32 caches; deepseek-v3's in bf16, the dtype of
   its benchmark cell, so that MLA takes B4) with 8 requests a model
   where phases 5 and 6 send 24: every request must complete, B1 launch
   once per attention layer per iteration and B4 once per MLA layer per
   decode and per chunk (twice a mixed iteration, once a solo one); the
   served B4 launches are the ``kernels`` line's; prints the host wall
   per mixed and solo iteration.  (c) a whole-prompt ``make_prefill_step(kernel_impl=
   "pallas")`` with bf16 caches and 8 ``forward_decode`` steps:
   paligemma B=4 over 256 stub patches and 512 tokens (B2 once per layer
   on tensor cores with ``prefix_len=256``), whisper B=4 over its 1500
   stub frames and 448 tokens (the encoder's time printed apart),
   grok-1 and deepseek-v3 at B=4 S=2048 (the decodes' device ms by CUDA
   events); B1 once per attention layer per decode, caches and logits
   finite.  Prints each model's parameters, the bytes held and the peak
   allocated.  (d) reduced paligemma (with ``prefix_embeds``), whisper
   (with ``enc_frames``), deepseek-v3 and grok-1 on the card against the
   CPU on the same weights within 1e-4, over a whole prefill, two
   continuation chunks and 8 decodes.  Phase 10's B1 and B2 launches
   join the kernels line's.
11. the training path (``[train]`` lines) -- ``forward_train``/
   ``loss_fn`` under autograd through ``make_train_step``.  (a) B3 under
   its ``autograd.Function`` at mamba2-130m's training shapes (B=4
   S=1024 H=24 P=64 N=128), bf16 and f32: y and the state as 3b holds
   them, every input grad the plain version's autograd grad, one forward
   launch on the dtype's route and none in the backward.  (b)
   ``run_training`` on ``preset_100m`` (12 layers, d_model 768, vocab
   8192) for 60 steps at batch 8 x 256, 2 microbatches, a checkpoint
   every 30 steps into a temporary directory: the mean loss of the last
   5 steps must be 0.05 below the first 5's, and a run resumed from the
   step-30 checkpoint must end within 1e-4 (relative) of the loss at
   every step it runs.  (c) mamba2-130m at its published width and depth
   (f32 params, bf16 activations), ``make_train_step(remat=True)``, 8
   steps at B=4 S=1024: ``ssd_scan`` launches 24 forwards and 24
   recomputes a step, all tensor-core; step 0's grads are finite and
   nonzero in every SSM leaf.  Against an all-plain step on the same
   card and weights: in bf16 the loss within ``TRAIN_BF16_LOSS`` and
   each grad leaf within ``TRAIN_BF16_GRAD`` (relative L2); the same
   step with f32 activations (the kernel's f32 route) the loss within
   1e-5 relative and each grad leaf within ``TRAIN_F32_GRAD``.
   (d) qwen2-0.5b at its published
   width and depth, 4 steps at B=4 S=512: finite losses.  (b)-(d) print
   the step's host ms (untraced), tokens/s, the peak allocated memory
   and the card's busy time a step over ``torch.profiler``'s window (the
   tracer's events read raw) with its idle share.  (e) reduced qwen2,
   mamba2 (the kernel on the card, the plain scan on the CPU),
   deepseek-v3, whisper and paligemma: one step's loss and every grad on
   the card within 1e-4 of the CPU's.  (f) ``quantize_int8``/
   ``dequantize_int8`` on the card equal to the CPU bit for bit, and the
   compressed psum over a one-rank NCCL group equal to a one-rank gloo
   group's on the CPU.  (c)'s ``ssd_scan`` launches join the kernels
   line's.
12. the dry run, the roofline and the examples (``[dry]`` lines) -- (a)
   ``repro_torch.launch.dryrun.run_cell`` over the single-pod mesh's 40
   cells (baseline strategy) in worker processes, each traced on the
   meta device into a temporary directory: 33 must be ``ok`` and 7
   long_500k cells skipped with the reference's reason; prints each
   cell's wall time, global and per-device FLOPs and bytes, argument GiB
   a device and dominant roofline term at the H100 SXM's table, then the
   roofline table (``render_table``) and ``perf_loop`` on qwen2-0.5b's
   decode_32k over baseline, kv_heads and kv_int8.  (b) qwen2-0.5b at its
   published width, bf16 params and full random bf16 caches, through
   ``make_decode_step(masked=False)`` at decode_32k's S=32768, at the
   largest batch of 128, 64, 32, 16, 8 whose state and the copy of it
   that its ``masked=True`` twin writes fit: B1 once per layer per step,
   and the new state equal to the twin's bit for bit; prints the step's
   device time beside the dry run's memory term for the same shapes at
   the card's table, and B1 at that shape against its plain version (a
   row of the kernels line's B1).  (c) the six ``examples/torch_*.py``
   at their reference defaults: the host's three (quickstart,
   elastic_failover, online_adaptive) in the pool beside (a), the card's
   three in this process; ``ctmc_scan`` must launch in
   ``torch_ctmc_jax_demo`` and B1 in ``torch_serve_cluster``.  (b)'s and
   (c)'s B1 launches join the kernels line's.

It then prints the per-kernel JSON line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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
# the fluid's graphed loop against its eager loop on the card: steps
FLUID_CMP_STEPS = 3000
# phase 8: bench_engine_speed's instance in full mode: its CLASSES (name,
# prompt, decode, lambda), the default primitives, pricing (c_p, c_d),
# 10 servers, synth_azure_trace(horizon 60, base_rate 2, compression
# 0.02, seed 11) = 5825 requests, 32 replications, gate-and-route
ES_CLASSES = (("chat", 512, 768, 0.2), ("agent", 1024, 1024, 0.1))
ES_PRICING = (0.1, 0.2)
ES_N, ES_HORIZON, ES_REPS = 10, 60.0, 32
# (events, iterations) over the 32 replications and the mean revenue rate
# of each leg: the JAX reference, float32 on the CPU, as committed in
# artifacts/bench/engine_speed.json (legs.legacy, legs.hot)
ES_REF = {"legacy": (519968.0, 333600.0, 941.5738718374661),
          "hot": (524128.0, 337760.0, 941.5738067305053)}
# revenue agreement, relative: the reference's own stream-vs-batch
# tolerance (tests/test_engine_diff.py)
ENGINE_RTOL = 1e-5
ES_TIMED = 3  # timed runs a leg, after one warm-up run that captures
# hot and hot+telemetry runs taken in turn for the telemetry overhead
ES_PAIRS = 5
# card vs CPU route: tests/test_engine_diff.py::_mk(seed=42) (8 servers,
# horizon 25, compression 0.2, padded to 512), one replay a policy
DIFF_POLICIES = ("gate_and_route", "vllm", "sarathi", "distserve", "sli")
# the streamed legs: test_stream_matches_batch's instance (seed 7,
# compression 0.3, horizon 30, chunk 160), then bench_engine_speed's
# quick ScenarioStream leg (azure_2023, 48 servers, rate_scale 20,
# window 8192, chunks of 2048 candidates, horizon 300)
STREAM_N, STREAM_RATE, STREAM_WINDOW, STREAM_CHUNK = 48, 20.0, 8192, 2048
STREAM_HORIZON = 300.0
# the two call lengths, in blocks, whose torch.profiler records are
# differenced for the card's busy time and idle share a loop step
ENGINE_PROFILE_BLOCKS = (1, 4)
# phase 9: bench_heterogeneity.py's FULL_CONTROL (n, seeds, horizon,
# warmup) and its artifact; the control's mean gap must sit within the
# optimality-gap study's noise floor (NOISE_FLOOR_PCT) of the committed
# control gap
CONTROL = (16, 32, 300.0, 75.0)
CONTROL_FLOOR_PCT = 1.0
HET_ARTIFACT = ROOT / "artifacts" / "bench" / "heterogeneity.json"
# bench_heterogeneity.py's WORKLOAD (name, prompt, decode, patience) at
# LAMBDA_PER_SERVER, and its FULL_FLEETS: instance -> (fleet, xfer scales)
FLEET_LAMBDA = 24.0
FLEET_WORKLOAD = (("decode-heavy", 300, 1000, 0.1),
                  ("prefill-heavy", 3000, 400, 0.1))
FULL_FLEETS = {
    "mixed_a100_h100": ((("a100-cal", 3), ("h100-cal", 3)),
                        (0.0, 1.0, 4.0)),
    "mixed_three_class": ((("a100-cal", 2), ("h100-cal", 2),
                           ("l4-cal", 2)), (1.0,)),
}
# bench_sensitivity.py's BASE_PRIM (its full-mode grid: _sensitivity_mixes)
SENS_BASE_PRIM = dict(alpha=0.0174, beta=6.2e-5, gamma=1 / 0.0089,
                      batch_cap=16, chunk=256)
# the fluid grid: the two_class mix at horizon 300, dt 2e-3; per policy
# the reference's float32 revenue rate and y_err_l1 (repro.sweep's fluid
# evaluator on a CPU under XLA; R* 305.0, x_err_l1 1e-6 for both)
FLUID_HORIZON, FLUID_DT = 300.0, 2e-3
FLUID_REF = {"gate_and_route": (304.961792, 2.357684),
             "sli_aware": (304.961792, 0.001406)}
# the sweep CLI's trace replay: scenarios x policies at n=8, 8 seeds,
# horizon 300 (both scenarios' own), fast-forward; one cell also on the
# CPU route, its discrete metrics exactly, the rest within ENGINE_RTOL
CLI_SCENARIOS = ("rate_shift", "azure_2023")
CLI_POLICIES = ("gate_and_route", "vllm")
CLI_N, CLI_SEEDS, CLI_HORIZON = 8, 8, 300.0
CLI_CPU_CELL = ("azure_2023", "gate_and_route")
CLI_EXACT = ("completions", "arrivals", "abandons", "budget_exhausted",
             "n_iters", "n_events", "n_steps", "n_dropped",
             "completion_rate")
# the closed loop: bench_scenarios.py's rate_shift comparison at
# ClosedLoopConfig(n_servers=8, seed=0) and its adaptive lead over the
# hindsight-static plan (artifacts/bench/scenarios.json)
CL_SCENARIO, CL_N = "rate_shift", 8
CL_VARIANTS = ("adaptive", "static", "static_cold", "vllm")
# phase 10: the archs of the rest of the data plane at their published
# widths, in this order; depth cut only where one card forces it (layers
# kept: deepseek-v3's first 3 dense and 1 MoE, grok-1's first 2)
A10_ARCHS = ("paligemma-3b", "whisper-base", "grok-1-314b",
             "deepseek-v3-671b", "recurrentgemma-2b")
A10_DEPTH = {"deepseek-v3-671b": 4, "grok-1-314b": 2}
# served through serve (whisper cannot be, ROADMAP C-ref7), 8 requests a
# model where phases 5 and 6 send 24
A10_SERVE = ("paligemma-3b", "grok-1-314b", "deepseek-v3-671b",
             "recurrentgemma-2b")
A10_REQUESTS = 8
# the caches of (b), f32 unless named here: deepseek-v3's in its
# benchmark cell's dtype, where MLA's decode and chunk run B4
A10_CACHE = {"deepseek-v3-671b": "bfloat16"}
# the whole-prompt prefill (B, text tokens) and the decodes after it
A10_WHOLE = {"paligemma-3b": (4, 512), "whisper-base": (4, 448),
             "grok-1-314b": (4, 2048), "deepseek-v3-671b": (4, 2048)}
A10_STEPS = 8
CL_LEAD = 5.374133740330568
# phase 11: the training path.  B3 under autograd at mamba2-130m's shapes
# (B, S, H, P, N); run_training on preset_100m; (B, S, steps) of the
# archs trained at their published width and depth; the reduced configs
# held card against CPU; the card-vs-CPU grads' limit (f32, summation
# order only)
TRAIN_SSD = (4, 1024, 24, 64, 128)
TRAIN_100M = dict(steps=60, batch=8, seq_len=256, microbatches=2,
                  ckpt_every=30)
TRAIN_FULL = {"mamba2-130m": (4, 1024, 8), "qwen2-0.5b": (4, 512, 4)}
TRAIN_REDUCED = ("qwen2-0.5b", "mamba2-130m", "deepseek-v3-671b",
                 "whisper-base", "paligemma-3b")
TRAIN_REL = 1e-4
# (c)'s kernel step against the all-plain step.  With bf16 activations
# the two round at different points, and bf16 noise grows with depth: at
# mamba2-130m's width, S=1024 and a 64-token chunk, the reference's own
# bf16 grads lie up to 8.2%, 14.6% and 32.0% (relative L2, per leaf) from
# its f32 grads over 4, 8 and 16 layers, the port's up to 6.7%, 13.1% and
# 30.2%, the port's bf16 grads up to 28.3% from the reference's over 16
# (tests/torch_bf16_grad_gap.py, on the CPU).  A leaf whose gradient
# path were lost would be ~100% off.  The loss at random init sits near
# ln V, so its bf16 limit is absolute, five times the two steps'
# difference on the card (4.3e-4).  In f32 the two steps differ by
# summation order alone.
TRAIN_BF16_GRAD = 0.3
TRAIN_BF16_LOSS = 2e-3
TRAIN_F32_GRAD = 1e-3
TRAIN_F32_LOSS = 1e-5
# phase 12: the dry run over the single-pod mesh's 40 cells (33 traced,
# 7 skipped with the reference's reason), the cell the perf loop runs
# over three strategies, the batches (b) tries at decode_32k (largest
# first), and the examples: the host's run in worker processes beside
# the dry run, the card's in this process with the launch counts
DRY_OK, DRY_SKIPS = 33, 7
DRY_SKIP = ("pure full-attention arch: 500k decode needs sub-quadratic "
            "attention")
PERF_LOOP = ("qwen2-0.5b", "decode_32k", "baseline,kv_heads,kv_int8")
DECODE_32K_BATCHES = (128, 64, 32, 16, 8)
HOST_EXAMPLES = ("torch_quickstart", "torch_elastic_failover",
                 "torch_online_adaptive")
CARD_EXAMPLES = ("torch_ctmc_jax_demo", "torch_engine_jax_demo",
                 "torch_serve_cluster")


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
    # the grok cells' mixed step: a 512-token chunk over one slot of the
    # (8, 8192, 8, 128) cache, ending at 512 .. 8192 keys, offset and
    # length read on the card; each chunk has a slot of its own, NaN past
    # its end, which must not reach it
    k, v = (torch.randn(8, 8192, 8, 128, generator=gen, device="cuda",
                        dtype=dt) for _ in range(2))
    for slot, off in enumerate((0, 1536, 5632, 7680)):
        end = off + 512
        k[slot, end:], v[slot, end:] = float("nan"), float("nan")
        q = torch.randn(1, 512, 48, 128, generator=gen, device="cuda",
                        dtype=dt)
        kw = dict(attn_softcap=30.0, **{
            n: torch.tensor([x], dtype=torch.int32, device="cuda")
            for n, x in (("q_offset", off), ("kv_len", end))})
        cases.append((f"C=512 kv_len={end} H=48 KV=8 D=128 grok chunk "
                      f"softcap=30", (q, k[slot:slot + 1], v[slot:slot + 1]),
                      kw))
    return cases


def _pairs(torch, S, causal=True, window=None, prefix_len=None,
           q_offset=0, kv_len=None) -> int:
    """Valid (query, key) pairs of a prefill mask: the work it needs.  A
    chunk's S queries sit at q_offset .. q_offset + S - 1 over kv_len
    keys (S without a chunk)."""
    qp = q_offset + torch.arange(S)[:, None]
    kp = torch.arange(S if kv_len is None else kv_len)[None, :]
    mask = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool)
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


def _decode_row(torch, ms, n_sm, dname, desc, args, kw, kv_read):
    """One B1 check: kernel against plain, with times and the bound."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain, decode_plan)

    q, k, v, kl = args
    el = torch.finfo(q.dtype).bits // 8
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
    row = dict(shape=desc, dtype=dname, max_abs_err=err, plan=plan,
               route=f"cluster={plan.n_split} split_len={plan.split_len} "
               f"kw={plan.kw} blocks={plan.blocks}",
               ms=ms(lambda: decode_attention(q, k, v, kl, **kw)),
               plain_ms=ms(lambda: decode_attention_plain(q, k, v, kl, **kw)),
               library_ms=lib)
    row["bound_ms"], row["bound_by"] = _bound(dname, bytes_, flops)
    return row


def _prefill_row(torch, ms, dname, desc, args, kw):
    """One B2 check: the call must take its dtype's route (bf16 ``tc``,
    f32 ``fp32``); kernel against plain, with times and the bound.  A
    chunk (``q_offset`` and ``kv_len``, one batch row) is held to the
    plain version over its first kv_len keys, as are its work and its
    library time: SDPA with the chunk's causal mask over those keys,
    without the softcap, which SDPA lacks."""
    from repro_torch.kernels.prefill_attention.ops import (
        prefill_attention, prefill_attention_plain)

    q, k, v = args
    el = torch.finfo(q.dtype).bits // 8
    route = "tc" if q.dtype == torch.bfloat16 else "fp32"
    H, D, KV = q.shape[2], q.shape[3], k.shape[2]
    n_route = getattr(prefill_attention, f"launches_{route}")
    out = prefill_attention(q, k, v, **kw)
    if getattr(prefill_attention, f"launches_{route}") != n_route + 1:
        raise AssertionError(f"prefill_attention {dname} {desc}: did not "
                             f"launch the {route} route")
    B, S = q.shape[:2]
    off, n_kv = 0, None
    if "kv_len" in kw:  # a chunk over the cache, one batch row
        off, n_kv = int(kw["q_offset"][0]), int(kw["kv_len"][0])
        k, v = k[:, :n_kv], v[:, :n_kv]
    ref = prefill_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = _check(torch, "prefill_attention", out, ref, dname, desc)
    pairs = B * _pairs(torch, S, kw.get("causal", True), kw.get("window"),
                       kw.get("prefix_len"), off, n_kv)
    n_keys = S if n_kv is None else n_kv
    bytes_ = B * (2 * S * H * D + 2 * n_keys * KV * D) * el
    if n_kv is not None:
        bytes_ += 2 * 4 * B  # q_offset and kv_len
    flops = 4.0 * pairs * H * D
    lib = None
    if set(kw) <= {"causal"}:
        lib = ms(_sdpa(torch, q, k, v, is_causal=kw.get("causal", True)))
    elif set(kw) == {"prefix_len"}:  # SDPA with the prefix-LM mask
        kp = torch.arange(S, device=q.device)
        mask = (kp[None, :] <= kp[:, None]) | (kp[None, :] < kw["prefix_len"])
        lib = ms(_sdpa(torch, q, k, v, attn_mask=mask))
    elif n_kv is not None:  # SDPA with the chunk's causal mask
        qp = off + torch.arange(S, device=q.device)
        mask = torch.arange(n_kv, device=q.device)[None, :] <= qp[:, None]
        lib = ms(_sdpa(torch, q, k, v, attn_mask=mask))
    row = dict(shape=desc, dtype=dname, max_abs_err=err, route=route,
               ms=ms(lambda: prefill_attention(*args, **kw)),
               plain_ms=ms(lambda: prefill_attention_plain(q, k, v, **kw)),
               library_ms=lib)
    row["bound_ms"], row["bound_by"] = _bound(dname, bytes_, flops)
    return row


MLA_SCALE = 0.1352  # deepseek-v3's 1/sqrt(192) x YaRN's mscale^2


def _mla_cases(torch, gen):
    """(description, (clean args), (args with NaN past each end), kwargs)
    of every B4 check, at the DeepSeek-V3 cell's widths (128 heads, a
    512-wide latent and a 64-wide RoPE key): its decode, 64 rows over
    their own 8192 slots at lengths spread over 1..8192 (both ends
    included), and its chunk, 512 queries over one slot ending at 512 ..
    8192 keys, from position 0 and from mid-cache."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    cases = []
    B, S, H = 64, 8192, 128
    lens = [0, 8191, 1, 17, 48, 1023, 1024, 1025, 4095] + [
        int(x) for x in torch.randint(0, S, (B - 9,), generator=gen,
                                      device="cuda").tolist()]
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")[:, None]
    args = (rnd(B, 1, H, 512), rnd(B, 1, H, 64), rnd(B, S, 512),
            rnd(B, S, 64), pos)
    past = torch.arange(S, device="cuda")[None, :, None] > pos[:, :, None]
    nan = args[:2] + tuple(a.masked_fill(past, float("nan"))
                           for a in args[2:4]) + (pos,)
    cases.append(("B=64 S=8192 H=128 decode, lengths 1..8192", args, nan,
                  {}))
    c, r = rnd(1, S, 512), rnd(1, S, 64)
    for off, end in ((0, 512), (1536, 2048), (5632, 6144), (7680, 8192),
                     (0, 2048)):
        q = (rnd(1, 512, H, 512), rnd(1, 512, H, 64))
        qpos = (off + torch.arange(512, dtype=torch.int32,
                                   device="cuda"))[None]
        cn, rn = c.clone(), r.clone()
        cn[:, end:], rn[:, end:] = float("nan"), float("nan")
        cases.append((f"C=512 q_offset={off} kv_len={end} H=128 chunk",
                      q + (c, r, qpos), q + (cn, rn, qpos),
                      {"kv_len": end}))
    return cases


def _mla_tolerance():
    """``tests/mla_tolerance.py``: B4's tolerance, one definition for the
    card tests and this script."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "mla_tolerance", ROOT / "tests" / "mla_tolerance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mla_row(torch, ms, desc, args, nan, kw):
    """One B4 check: the kernel over latents with NaN past each query's
    end against the plain version over clean ones, held as the card tests
    hold it (``tests/mla_tolerance.py``: one bf16 step of p where the two
    f32 scores straddle a rounding point; at most 0.5% of outputs past one
    rounding step of the output); times, the bound."""
    from repro_torch.kernels.mla_attention.ops import (
        mla_attention, mla_attention_plain, mla_split)

    tol = _mla_tolerance()
    ql, qr, ck, kr, pos = args
    n = mla_attention.launches
    out = mla_attention(*nan, scale=MLA_SCALE, **kw)
    if mla_attention.launches != n + 1:
        raise AssertionError(f"mla_attention {desc}: no launch")
    kv = kw.get("kv_len", ck.shape[1])
    gap = tol.mla_gap(out, *args, MLA_SCALE, kw.get("kv_len"))
    if not gap["finite"] or not gap["within"] or gap["past"] > tol.PAST:
        raise AssertionError(f"mla_attention {desc}: {gap}")
    err, past = gap["max_abs_err"], gap["past"]
    B, Sq, H = ql.shape[:3]
    last = torch.clamp(pos.long(), max=kv - 1) + 1
    keys = int(last.sum())
    el = 2
    bytes_ = el * (((kv if Sq > 1 else keys) + B * Sq * H) * 576
                   + B * Sq * H * 512) + 4 * B * Sq
    flops = float(keys) * H * (2 * 576 + 2 * 512)
    split, n_split = mla_split(B * Sq, H, kv,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    row = dict(shape=desc, dtype="bfloat16", max_abs_err=err,
               route=f"pieces={n_split} split={split} past_one_step={past}",
               ms=ms(lambda: mla_attention(*args, scale=MLA_SCALE, **kw)),
               plain_ms=ms(lambda: mla_attention_plain(
                   *args, scale=MLA_SCALE, **kw)),
               library_ms=None)  # SDPA: no 576-wide key with a 512 value
    row["bound_ms"], row["bound_by"] = _bound("bfloat16", bytes_, flops)
    return row


def _print_rows(rows, tag="kernel"):
    for name, rs in rows.items():
        for r in rs:
            print(f"[{tag}] {name} {r['dtype']} {r['shape']} "
                  f"({r['route']}): max_abs_err={r['max_abs_err']!r} "
                  f"(atol, rtol {TOL[r['dtype']]}) ms={r['ms']!r} "
                  f"plain_ms={r['plain_ms']!r} "
                  f"library_ms={r['library_ms']!r} bound_ms={r['bound_ms']!r} "
                  f"({r['bound_by']})")


def check_kernels(torch):
    from repro_torch.telemetry.timing import timeit_median_cuda

    def ms(fn):
        return timeit_median_cuda(fn) * 1e3

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"decode_attention": [], "prefill_attention": []}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for desc, args, kw, kv_read in _decode_cases(torch, gen, dt):
            rows["decode_attention"].append(
                _decode_row(torch, ms, n_sm, dname, desc, args, kw, kv_read))
        for desc, args, kw in _prefill_cases(torch, gen, dt):
            rows["prefill_attention"].append(
                _prefill_row(torch, ms, dname, desc, args, kw))
    rows["mla_attention"] = [_mla_row(torch, ms, *case)
                             for case in _mla_cases(torch, gen)]
    _print_rows(rows)
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
    prefill_attention.prefix_lens.clear()


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


def run_serving(torch, arch, *, cfg=None, n_req=24, dtype=None,
                cache_dtype=None):
    """The serving path at full width: ``arch`` (or ``cfg``, a depth cut
    of it) through ``serve``, ``n_req`` requests over weights drawn in
    ``dtype`` (f32 by default); the engines' caches in ``cache_dtype``
    where given (``serve``'s own are f32, as the reference's).

    ``torch.profiler`` records ``PROFILE_N`` iterations of this same run
    from iteration ``PROFILE_FROM * n_req // 24`` (the first are warm-up;
    all of them would be millions of events): 150-209 of 506 at 24
    requests, 50-109 of 180 at 8.  Each engine step in that window is a
    range, ``iteration.mixed`` or ``iteration.solo``: the device time of
    the kernels inside a kind's ranges, over the ranges' host wall, is
    the card's busy share there.  The run's host wall per iteration
    (``iter_wall``) is printed for the iterations outside the window,
    which neither the profiler nor its start and stop slow.  Returns the
    metrics and the run's kernel launches (the counts are zeroed just
    before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import ServerEngine

    cfg = cfg or get_config(arch)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {"modes": [], "wall": 0.0, "open": False}
    engine_step = ServerEngine.step
    start = PROFILE_FROM * n_req // 24

    def step(self):  # the engine's step, with the profiler's window
        if len(window["modes"]) == start:
            torch.cuda.synchronize()
            prof.start()
            window["open"] = True
            window["wall"] = -time.perf_counter()
        mode = "mixed" if self.has_prefill else "solo"
        with record_function(f"iteration.{mode}"):
            res = engine_step(self)
        window["modes"].append(mode)
        if len(window["modes"]) == start + PROFILE_N:
            torch.cuda.synchronize()
            window["wall"] += time.perf_counter()
            prof.stop()
            window["open"] = False
        return res

    engine_init = ServerEngine.__init__

    def init(self, *args, **kw):  # the engine, its caches in cache_dtype
        engine_init(self, *args, **dict(kw, dtype=cache_dtype))

    _zero_counts()
    ServerEngine.step = step
    if cache_dtype is not None:
        ServerEngine.__init__ = init
    try:
        t0 = time.perf_counter()
        m = serve(cfg, servers=4, requests=n_req, batch_cap=4, chunk=16,
                  rate=2.0, seed=0, device="cuda",
                  dtype=dtype or torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ServerEngine.step = engine_step
        ServerEngine.__init__ = engine_init
        if window["open"]:  # never leave the tracer running
            prof.stop()
    modes = window["modes"]
    if len(modes) < start + PROFILE_N:
        raise AssertionError(f"serving {arch}: the run ended after "
                             f"{len(modes)} iterations, inside the profiled "
                             f"window {start}-{start + PROFILE_N - 1}")
    launches = _counts()
    mixer = (f"H={cfg.attn.n_heads} KV={cfg.attn.n_kv_heads} "
             f"D={cfg.attn.head_dim}" if cfg.attn is not None else
             f"MLA H={cfg.mla.n_heads} r={cfg.mla.kv_lora_rank}"
             if cfg.mla is not None else
             f"N={cfg.ssm.d_state} P={cfg.ssm.head_dim}")
    print(f"[serve] {arch} (layers={cfg.n_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {mixer}) served in {wall:.1f} s; "
          f"launches {launches}")
    if launches["decode_attention"]:
        print(f"[serve] {arch} decode_attention routes: {_b1_routes()}")
    print(f"[serve] summary {json.dumps(m.summary(), sort_keys=True)}")
    for mode, ts in m.iter_wall.items():
        # this mode's iterations inside the profiled window
        skip = {modes[:i].count(mode) for i in range(start, start + PROFILE_N)
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

    # the tracer's raw events, in microseconds (``prof.events()`` would
    # build a tree over them: ~0.5 ms an event); the ranges appear twice,
    # on the host and on the device as the span of their kernels
    raw = prof.profiler.kineto_results.events()
    t00 = min(e.start_ns() for e in raw)
    events = [(e.name(), e.device_type(), (e.start_ns() - t00) / 1e3,
               (e.end_ns() - t00) / 1e3) for e in raw]
    device = [e for e in events if e[1] == DeviceType.CUDA
              and not e[0].startswith("iteration.")]
    kernels = sorted((e[2], e[3]) for e in device)
    total = sum(k1 - k0 for k0, k1 in kernels)
    print(f"[serve] profiled iterations {start}-"
          f"{start + PROFILE_N - 1} of this run: {len(kernels)} device "
          f"events, {total / 1e3!r} device ms in {1e3 * window['wall']!r} ms "
          f"of host wall: device idle {1 - total / 1e6 / window['wall']!r}")
    for mode in ("mixed", "solo"):
        ranges = sorted((e[2], e[3]) for e in events
                        if e[0] == f"iteration.{mode}"
                        and e[1] == DeviceType.CPU)
        if not ranges:
            raise AssertionError(f"serving {arch}: no {mode} iteration in "
                                 f"the profiled window")
        busy = _busy_us(kernels, ranges)
        span = sum(r1 - r0 for r0, r1 in ranges)
        print(f"[serve] profiled {mode} iterations: {len(ranges)}, host wall "
              f"ms mean {span / 1e3 / len(ranges)!r}, device busy ms mean "
              f"{busy / 1e3 / len(ranges)!r}: device idle {1 - busy / span!r}")
    by_kernel = {}
    for name, _, t0, t1 in device:
        by_kernel[name] = by_kernel.get(name, 0.0) + t1 - t0
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


def _n_mla(cfg) -> int:
    return sum(s.mixer == "mla" for s in cfg.block_specs())


def _finite(torch, tree) -> bool:
    """Every floating leaf of a cache tree finite (one host sync)."""
    from repro_torch.models.params import tree_map

    flags = []
    tree_map(lambda a: flags.append(torch.isfinite(a).all())
             if a.is_floating_point() else None, tree)
    return bool(torch.stack(flags).all())


def _whole_prompt(torch, cfg, params, B, S, steps, *, stubs=None,
                  tag="attn"):
    """``cfg`` with ``params`` (drawn by the caller): a whole-prompt
    prefill of ``S`` tokens (after the stubs' prefix, if any) through
    ``make_prefill_step(kernel_impl="pallas")`` with bf16 caches, then
    ``steps`` decodes on them through ``forward_decode``.  Every attention
    layer must run B2 once on its activations' route (bf16: tensor cores)
    with the prefix's length, and B1 once per decode on that dtype's
    route; the caches and every logit must be finite.  Prints host walls
    and the card's busy ms a decode; returns the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.models import model as M
    from repro_torch.models.config import segment_layers
    from repro_torch.serving.steps import make_prefill_step

    stubs = stubs or {}
    n_attn = _n_attn(cfg)
    P = stubs["prefix_embeds"].shape[1] if "prefix_embeds" in stubs else None
    route, b1_dtype = (("tc", "bfloat16") if cfg.param_dtype == "bfloat16"
                       else ("fp32", "float32"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    caches = M.init_cache(cfg, B, (P or 0) + S + steps, torch.bfloat16,
                          "cuda")
    enc = ""
    if "enc_frames" in stubs:  # the encoder alone, then again in the step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.encoder_forward(cfg, params, stubs["enc_frames"])
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        enc = (f"; the encoder ({cfg.encoder.n_layers} layers over "
               f"{cfg.encoder.n_frames} frames) {1e3 * t_enc!r} ms of it, "
               f"the decoder the rest")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches, nxt = make_prefill_step(cfg, kernel_impl="pallas")(
        params, caches, toks, pos, **stubs)
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    n_route = getattr(prefill_attention, f"launches_{route}")
    if prefill_attention.launches != n_attn or n_route != n_attn \
            or prefill_attention.prefix_lens[P] != n_attn:
        raise AssertionError(
            f"{cfg.name} prefill: B2 launched {prefill_attention.launches} "
            f"times, {n_route} on the {route} route, by prefix_len "
            f"{dict(prefill_attention.prefix_lens)}; expected {n_attn} with "
            f"prefix_len {P}")
    if not _finite(torch, caches):
        raise AssertionError(f"{cfg.name} prefill: non-finite cache values")
    ok = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        last = (nxt[:, None], torch.full((B,), (P or 0) + S + i,
                                         dtype=torch.int32, device="cuda"),
                caches)
        logits, caches = M.forward_decode(cfg, params, *last)
        ok.append(torch.isfinite(logits.float()).all())
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / steps
    on_route = sum(n for (dt, _), n in decode_attention.routes.items()
                   if dt == b1_dtype)
    if decode_attention.launches != steps * n_attn \
            or on_route != steps * n_attn:
        raise AssertionError(f"{cfg.name} decode: B1 launched "
                             f"{decode_attention.launches} times ({on_route} "
                             f"{b1_dtype}); expected {steps} x {n_attn}")
    if logits.shape != (B, 1, cfg.vocab_size) \
            or not bool(torch.stack(ok).all()):
        raise AssertionError(f"{cfg.name} B={B} S={S}: bad logits "
                             f"{tuple(logits.shape)} or non-finite values")
    ring = ""
    local = [seg[f"b{i}"]["pos"] for seg, (block, _) in
             zip(caches, segment_layers(cfg.block_specs()))
             for i, spec in enumerate(block) if spec.mixer == "attn_local"]
    if local:
        lo, hi = int(local[0].min()), int(local[0].max())
        if not (hi == S + steps - 1 and lo == S + steps - local[0].shape[-1]):
            raise AssertionError(f"{cfg.name}: the local ring holds "
                                 f"positions {lo}..{hi}, expected the last "
                                 f"{local[0].shape[-1]} of {S + steps}")
        ring = (f"; local ring of {local[0].shape[-1]} wrapped, holds "
                f"positions {lo}..{hi}")
    counts, routes = _counts(), _b1_routes() or "none"
    by_plan = dict(decode_attention.routes)
    # the card's busy time a decode: the last decode twice more under the
    # profiler (it writes the same position of the same caches again), the
    # sum of its device events over the calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            M.forward_decode(cfg, params, *last)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in dev) / 2e3
    mixer = (f"H={cfg.attn.n_heads} KV={cfg.attn.n_kv_heads} "
             f"D={cfg.attn.head_dim}" if cfg.attn is not None else
             f"MLA H={cfg.mla.n_heads} r={cfg.mla.kv_lora_rank}")
    print(f"[{tag}] {cfg.name} (layers={cfg.n_layers}, {n_attn} attention, "
          f"d_model={cfg.d_model} {mixer} vocab={cfg.vocab_size}, weights "
          f"{params['embed'].dtype}) prefill step (kernel_impl='pallas') "
          f"B={B} S={S}" + (f" after a {P}-patch prefix" if P else "")
          + f", bf16 caches: {1e3 * t_pf!r} ms host wall (first call){enc}; "
          f"B2 {prefill_attention.launches} launches on the {route} route "
          f"(prefix_len {P}); {steps} decodes {1e3 * t_dec!r} ms each (host "
          f"wall), the card busy {busy!r} ms a decode ({len(dev) // 2} "
          f"device events; profiler): idle {1 - busy / (1e3 * t_dec)!r}; "
          f"B1 routes: {routes}; logits finite{ring}")
    return counts, by_plan


def _reduced_matches_cpu(torch, arch, tag="attn"):
    """Reduced ``arch`` on the card against the CPU on the same weights
    (seed 0): a whole prefill of 40 tokens (B2 on the card), two 16-token
    continuation chunks, 8 decodes (B1), every prefill with the config's
    stubs and the decodes past the prefix; logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    small = get_config(arch, reduced=True)
    p_cpu = M.init_model(small, torch.Generator().manual_seed(0),
                         device="cpu")
    rng = torch.Generator().manual_seed(3)
    stubs = _stubs(torch, small, 2, rng)
    P = small.vision.n_patches if small.vision is not None else 0
    calls = [(torch.randint(0, small.vocab_size, (2, 40), generator=rng,
                            dtype=torch.int32), 0, False)]
    calls += [(torch.randint(0, small.vocab_size, (2, 16), generator=rng,
                             dtype=torch.int32), p0, True) for p0 in (40, 56)]
    calls += [(torch.randint(0, small.vocab_size, (2, 1), generator=rng,
                             dtype=torch.int32), P + 72 + i, None)
              for i in range(8)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), p_cpu)
        kw = {k: v.to(dev) for k, v in stubs.items()}
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
                    continuation=cont,
                    kv_len=p0 + t.shape[1] if cont else None, **kw)
            outs[dev].append(lg.cpu())
    err = max(float((a - b).abs().max())
              for a, b in zip(outs["cpu"], outs["cuda"]))
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not bool(((a - b).abs() <= 1e-4 + 1e-4 * a.abs()).all()):
            raise AssertionError(f"reduced {arch}: card vs CPU max abs err "
                                 f"{err} beyond 1e-4")
    print(f"[{tag}] reduced {arch} on the card matches the CPU over a whole "
          f"prefill, 2 continuation chunks and 8 decodes"
          + (f" ({', '.join(stubs)})" if stubs else "")
          + f": logits max abs err {err!r}")


def check_attention_outputs(torch):
    """Whole-prompt prefill and decode at full width (qwen2-0.5b, gemma2-2b
    past its window); reduced attention models on the card against the
    CPU's plain versions on the same weights.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    total = {}
    for arch, B, S, steps in (("qwen2-0.5b", 4, 2048, 16),
                              ("gemma2-2b", 1, 4608, 4)):
        cfg = get_config(arch)
        params = M.init_model(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        _zero_counts()
        for k, n in _whole_prompt(torch, cfg, params, B, S,
                                  steps)[0].items():
            total[k] = total.get(k, 0) + n
        del params
        torch.cuda.empty_cache()

    # reduced configs (window 32): the rings wrap
    for arch in ("qwen2-0.5b", "gemma2-2b", "recurrentgemma-2b"):
        _reduced_matches_cpu(torch, arch)
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
          f"150000 steps on the card, CUDA graphs of "
          f"{_fluid_graph_steps()} steps between record points): "
          f"{wall_f:.2f} s host wall "
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
    eq, per = _fluid_graph_vs_eager(torch, classes, prim, pricing, plan)
    print(f"[gap] fluid loop, {FLUID_CMP_STEPS} steps from zero, one "
          f"record point a {FLUID_CMP_STEPS // 5}: eager {per[False]:.1f} "
          f"us a step, CUDA graphs {per[True]:.1f} us a step (capture "
          f"included); bit for bit equal: {eq}")
    if not eq:
        raise AssertionError("the graphed fluid loop differs from eager")
    row.update(launches=launches, main_ms=wall, main_bound_ms=bound,
               main_bound_by=by, main_shape=(
                   "gap run: " + ", ".join(f"{scheme} n={n} x {len(s)}"
                                           for (_, s), (scheme, n)
                                           in zip(cells, keys))))
    return row


def _fluid_graph_vs_eager(torch, classes, prim, pricing, plan):
    """The fluid's Euler loop eager and graphed on the card, from the
    same state, with record points: (bit for bit equal, us a step)."""
    from repro_torch.core.fluid import _integrate, fluid_params

    p = fluid_params(classes, prim, pricing, plan)
    z = torch.zeros_like(p["lam"])
    rec = tuple(range(0, FLUID_CMP_STEPS, FLUID_CMP_STEPS // 5))
    outs, per = {}, {}
    for graphed in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[graphed] = _integrate(p, (z,) * 6, 2e-3, FLUID_CMP_STEPS,
                                   False, rec, graphed=graphed)
        torch.cuda.synchronize()
        per[graphed] = 1e6 * (time.perf_counter() - t0) / FLUID_CMP_STEPS
    (ra, fa), (rb, fb) = outs[False], outs[True]
    eq = all(torch.equal(a, b) for a, b in zip(ra + fa, rb + fb))
    return eq, per


def _fluid_graph_steps() -> int:
    from repro_torch.core.fluid import _graph_steps

    return _graph_steps(3000)  # fluid_steady_state's record stride


# ------------------------------------------------------- phase 8: engines
def _diff_instance(seed=42, compression=0.2, horizon=25.0):
    """tests/test_engine_diff.py::_mk through the port: (padded tensors,
    trace, classes, plan) on 8 servers."""
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
    return tensorize_trace(trace, pad_to=512), trace, classes, plan


def _diff_engine(name, device, **kw):
    from repro_torch.core import policies as po
    from repro_torch.core.types import Pricing, ServicePrimitives
    from repro_torch.serving.engine_jax import ClusterEngineJAX
    from repro_torch.serving.engine_sim import EngineConfig

    make = {"gate_and_route": po.gate_and_route, "vllm": po.baseline_vllm,
            "sarathi": po.baseline_sarathi,
            "distserve": lambda p: po.baseline_distserve(p, 3),
            "sli": po.sli_aware_policy}[name]
    tt, _, classes, plan = _diff_instance()
    return ClusterEngineJAX(classes, make(plan), EngineConfig(
        ServicePrimitives(), Pricing(0.1, 0.2), n_servers=8), tt,
        horizon=25.0, device=device, **kw)


def _cpu_replay(name: str) -> dict:
    """One policy's replay on the port's CPU route, in a worker process
    (the card's twin is replayed meanwhile)."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    raw = _diff_engine(name, "cpu").run_batch_raw([0])
    return {"raw": {k: v.numpy() for k, v in raw.items()},
            "s": time.perf_counter() - t0}


def _same_replay(a: dict, b: dict, label: str) -> None:
    """Discrete outcomes equal, times and revenue within ENGINE_RTOL."""
    import numpy as np

    for k in ("st", "n_events", "n_iters", "abandons", "aptr", "t_first",
              "t_last", "rev", "t"):
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        ok = (np.allclose(x, y, rtol=ENGINE_RTOL, atol=0.0, equal_nan=True)
              if k in ("t_first", "t_last", "rev", "t")
              else np.array_equal(x, y))
        if not ok:
            raise AssertionError(f"{label}: {k} differs")


def _es_engine(fastforward: bool, telemetry=None, max_steps=None):
    from repro_torch.core.planning import solve_bundled_lp
    from repro_torch.core.policies import gate_and_route
    from repro_torch.core.types import (Pricing, ServicePrimitives,
                                        WorkloadClass)
    from repro_torch.data.traces import TraceConfig, synth_azure_trace
    from repro_torch.serving.engine_jax import ClusterEngineJAX
    from repro_torch.serving.engine_sim import EngineConfig

    classes = [WorkloadClass(*c) for c in ES_CLASSES]
    prim, pricing = ServicePrimitives(), Pricing(*ES_PRICING)
    trace = synth_azure_trace(TraceConfig(horizon=ES_HORIZON, base_rate=2.0,
                                          compression=0.02, seed=11))
    plan = solve_bundled_lp(classes, prim, pricing)
    return ClusterEngineJAX(classes, gate_and_route(plan),
                            EngineConfig(prim, pricing, ES_N), trace,
                            horizon=ES_HORIZON, fastforward=fastforward,
                            telemetry=telemetry, max_steps=max_steps)


def _step_bytes(eng, reps: int) -> int:
    """The bytes one loop step must touch, read and written once: the
    per-server, per-slot and per-class state of every replication (the
    carry without its per-request arrays).  The per-request gathers and
    scatters are left out, so the bound is a lower one."""
    from repro_torch.serving.engine_jax import _init_carry

    st = eng.statics
    c = _init_carry(eng.trace.R, st["n"], st["B"], eng.I, eng.dtype,
                    st["router_kind"], st["has_pw"], st["expiry"],
                    st["k_events"], st["fastforward"], st["telemetry"],
                    nr=reps, device="cpu")
    return 2 * sum(v.numel() * v.element_size() for v in c.values()
                   if v.shape[1:2] != (eng.trace.R,)
                   and v.shape[1:2] != (c["st"].shape[1] + st["B"] + 1,))


def _engine_busy(torch, fastforward: bool) -> dict:
    """The card's busy time a loop step, without a call's set-up: two
    engine_speed calls of ENGINE_PROFILE_BLOCKS blocks, each captured
    beforehand, under ``torch.profiler``.  Both calls hold the same
    set-up (carry init, copies into the graph's buffers, clones out), so
    the differences of their device time (kernels and copies) and of
    their device span (first start to last end) belong to the extra
    blocks' steps alone.  The tracer stretches the span (it records
    every graph node), so the caller sets the busy time against the
    untraced leg's wall a step for the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import engine_jax as ej

    rec = []
    for blocks in ENGINE_PROFILE_BLOCKS:
        eng = _es_engine(fastforward, max_steps=blocks * ej.BLOCK_STEPS)
        keys = [eng._key(s) for s in range(ES_REPS)]
        ej.run(eng.params, keys, **eng.statics)  # captures this length
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ej.run(eng.params, keys, **eng.statics)
            torch.cuda.synchronize()
        dev = [e.time_range for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if not dev:
            raise AssertionError("torch.profiler recorded no device event "
                                 "in the engine's loop")
        rec.append((len(dev), sum(r.end - r.start for r in dev),
                    max(r.end for r in dev) - min(r.start for r in dev)))
    (n0, b0, s0), (n1, b1, s1) = rec
    steps = (ENGINE_PROFILE_BLOCKS[1] - ENGINE_PROFILE_BLOCKS[0]) \
        * ej.BLOCK_STEPS
    return {"events_step": (n1 - n0) / steps,
            "busy_ns_step": 1e3 * (b1 - b0) / steps,
            "span_ns_step": 1e3 * (s1 - s0) / steps}


def check_engine(torch):
    """Phase 8: the trace-replay engines on the card (module docstring)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from repro_torch.serving import engine_jax as ej

    rows = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(DIFF_POLICIES),
                             mp_context=ctx) as pool:
        # (b)'s CPU route first, so that it overlaps the card's legs
        cpu = {nm: pool.submit(_cpu_replay, nm) for nm in DIFF_POLICIES}

        # (a) the engine_speed legs, 32 replications in one call each;
        # hot and hot+tlm are timed in turn, so that drift between runs
        # falls on both
        seeds = list(range(ES_REPS))
        legs = {}
        for tag, ff, tlm in (("legacy", False, None), ("hot", True, None),
                             ("hot+tlm", True, True)):
            eng = _es_engine(ff, tlm)
            keys = [eng._key(s) for s in seeds]

            def leg(eng=eng, keys=keys):
                out = ej.run(eng.params, keys, placement="vmap",
                             **eng.statics)
                torch.cuda.synchronize()
                return out

            t0 = time.perf_counter()
            leg()  # warm-up: builds and captures the block's graph
            legs[tag] = {"eng": eng, "ff": ff, "run": leg, "walls": [],
                         "warm": time.perf_counter() - t0}

        def timed(tag):
            r0 = ej.run.graph_replays
            t0 = time.perf_counter()
            raw = legs[tag]["run"]()
            legs[tag]["walls"].append(time.perf_counter() - t0)
            legs[tag]["raw"] = raw
            legs[tag]["replays"] = ej.run.graph_replays - r0

        for _ in range(ES_TIMED):
            timed("legacy")
        for _ in range(ES_PAIRS):
            timed("hot")
            timed("hot+tlm")
        for tag, lg in legs.items():
            eng, raw, walls = lg["eng"], lg["raw"], lg["walls"]
            replays = lg["replays"]
            wall = sorted(walls)[len(walls) // 2]
            events = float(raw["n_events"].sum())
            iters = float(raw["n_iters"].sum())
            sums = eng.summaries_from_raw(raw)
            rev = float(np.mean([m["revenue_rate"] for m in sums]))
            exhausted = max(m["budget_exhausted"] for m in sums)
            steps = float(raw["n_loop"].max())
            if replays <= 0:
                raise AssertionError(f"engine_speed {tag}: no CUDA-graph "
                                     f"replay ran the loop")
            bound_ms = 1e3 * _step_bytes(eng, ES_REPS) * steps / HBM_BW
            rows[tag] = {"wall_s": wall, "events": events, "iters": iters,
                         "steps": steps, "replays": replays,
                         "ns_step": 1e9 * wall / steps,
                         "events_per_s": events / wall, "rev": rev,
                         "bound_ms": bound_ms}
            print(f"[engine] {tag}: events {events:.0f} iters {iters:.0f} "
                  f"rev {rev!r} budget_exhausted {exhausted}; wall "
                  f"{1e3 * wall:.3f} ms (median of {len(walls)}; runs "
                  f"{', '.join(f'{1e3 * w:.3f}' for w in walls)}; warm-up "
                  f"with capture {lg['warm']:.2f} s); loop steps "
                  f"{steps:.0f} a replication, {replays} graph replays of "
                  f"K={ej.BLOCK_STEPS} steps, {1e9 * wall / steps:.0f} "
                  f"ns a loop step, {events / wall:.4g} events/s; bound "
                  f"{bound_ms:.4f} ms (bytes: {_step_bytes(eng, ES_REPS)} "
                  f"a step)")
            if exhausted != 0:
                raise AssertionError(f"engine_speed {tag}: budget exhausted")
            if tag != "hot+tlm":
                b = _engine_busy(torch, lg["ff"])
                idle = 1.0 - b["busy_ns_step"] / (1e9 * wall / steps)
                rows[tag]["idle"] = idle
                print(f"[engine] {tag}: torch.profiler, calls of "
                      f"{ENGINE_PROFILE_BLOCKS[0]} and "
                      f"{ENGINE_PROFILE_BLOCKS[1]} blocks differenced (a "
                      f"call's set-up excluded): {b['events_step']:.1f} "
                      f"device events and {b['busy_ns_step']:.0f} ns busy "
                      f"a loop step (traced span {b['span_ns_step']:.0f} "
                      f"ns); against the untraced leg's "
                      f"{1e9 * wall / steps:.0f} ns a loop step the card "
                      f"idles {idle!r} of the loop (below 0: the traced "
                      f"kernels ran longer than the untraced step)")
            want = ES_REF["hot" if lg["ff"] else "legacy"]
            if (events, iters) != want[:2] or not math.isclose(
                    rev, want[2], rel_tol=ENGINE_RTOL):
                raise AssertionError(
                    f"engine_speed {tag}: events/iters/revenue {events}, "
                    f"{iters}, {rev!r}; the reference has {want}")
        # events/s lost to telemetry, pair by pair: 1 - w_hot / w_tlm
        over = sorted(100.0 * (1.0 - h / t) for h, t in
                      zip(legs["hot"]["walls"], legs["hot+tlm"]["walls"]))
        rows["hot+tlm"]["overhead_pct"] = over[len(over) // 2]
        print(f"[engine] telemetry overhead {over[len(over) // 2]:+.2f}% "
              f"events/s (hot+tlm vs hot; median of {len(over)} pairs run "
              f"in turn, range {over[0]:+.2f}% to {over[-1]:+.2f}%)")

        # (b) the card against the port's CPU route, one replay a policy
        for nm in DIFF_POLICIES:
            eng = _diff_engine(nm, None)
            t0 = time.perf_counter()
            raw = eng.run_batch_raw([0])
            card_s = time.perf_counter() - t0
            got = cpu[nm].result(timeout=900)
            _same_replay({k: v.cpu().numpy() for k, v in raw.items()},
                         got["raw"], f"card vs CPU, {nm}")
            s = eng.summaries_from_raw(raw)[0]
            print(f"[engine] card == CPU route: {nm} ({eng.router_kind}, "
                  f"{eng.gate_kind}) events {s['n_events']:.0f} arrivals "
                  f"{s['arrivals']} completions {s['completions']} abandons "
                  f"{s['abandons']}; card {card_s:.2f} s with capture, CPU "
                  f"{got['s']:.2f} s")

    # (c) streamed replay on the card
    rows["stream"] = check_stream(torch)
    return rows


def check_stream(torch):
    from repro_torch.core.planning import solve_bundled_lp
    from repro_torch.core.policies import baseline_vllm, gate_and_route
    from repro_torch.core.types import Pricing, ServicePrimitives, \
        WorkloadClass
    from repro_torch.data.traces import tensorize_trace
    from repro_torch.serving import engine_jax as ej
    from repro_torch.serving.engine_jax import ClusterEngineJAX
    from repro_torch.serving.engine_sim import EngineConfig
    from repro_torch.serving.engine_stream import (StreamingEngineJAX,
                                                   TraceChunkSource)
    from repro_torch.workloads import get_scenario
    from repro_torch.workloads.batch import ScenarioStream

    prim, pricing = ServicePrimitives(), Pricing(0.1, 0.2)
    _, trace, classes, plan = _diff_instance(7, 0.3, 30.0)
    trace = [type(r)(rid=r.rid, t_arrival=r.t_arrival, cls=r.cls,
                     prompt_len=r.prompt_len, decode_len=r.decode_len,
                     patience=float("inf")) for r in trace]
    cfg = EngineConfig(prim, pricing, n_servers=8)
    for make in (gate_and_route, baseline_vllm):
        pol = make(plan)
        ref = ClusterEngineJAX(classes, pol, cfg, tensorize_trace(trace),
                               horizon=30.0, drain=True,
                               fastforward=True).run(0)
        s = StreamingEngineJAX(classes, pol, cfg, horizon=30.0,
                               window=512).run_stream(
            TraceChunkSource(trace, chunk_size=160), seed=0)
        for k in ("arrivals", "completions", "abandons"):
            if s[k] != ref[k]:
                raise AssertionError(f"stream vs batch ({pol.router}): {k} "
                                     f"{s[k]} != {ref[k]}")
        if (not math.isclose(s["revenue_rate"], ref["revenue_rate"],
                             rel_tol=ENGINE_RTOL)
                or s["budget_exhausted"] != 0 or s["n_segments"] < 2):
            raise AssertionError(f"stream vs batch ({pol.router}): {s}")
        print(f"[engine] stream == drain batch ({pol.router}): arrivals "
              f"{s['arrivals']} completions {s['completions']} revenue "
              f"{s['revenue_rate']!r} / {ref['revenue_rate']!r}, "
              f"{s['n_segments']} segments")

    sc = get_scenario("azure_2023")
    lam = 2.44 * STREAM_RATE / STREAM_N
    s_classes = [WorkloadClass(p.name, int(p.mean_prompt),
                               int(p.mean_decode), lam * p.share)
                 for p in sc.profiles]
    s_plan = solve_bundled_lp(s_classes, prim, pricing)
    eng = StreamingEngineJAX(s_classes, gate_and_route(s_plan),
                             EngineConfig(prim, pricing, STREAM_N),
                             horizon=STREAM_HORIZON, window=STREAM_WINDOW)
    r0 = ej.run.graph_replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = eng.run_stream(ScenarioStream(sc, seed=3, chunk_size=STREAM_CHUNK,
                                      horizon=STREAM_HORIZON,
                                      rate_scale=STREAM_RATE), seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replays = ej.run.graph_replays - r0
    step_bytes = _step_bytes(eng._base, 1)
    row = {"wall_s": wall, "requests": s["requests"],
           "bound_ms": 1e3 * step_bytes * s["n_loop"] / HBM_BW,
           "segments": s["n_segments"], "window_peak": s["window_peak"],
           "events": s["n_events"], "steps": s["n_loop"],
           "replays": replays, "events_per_s": s["n_events"] / wall,
           "ns_step": 1e9 * wall / max(s["n_loop"], 1.0)}
    print(f"[engine] ScenarioStream azure_2023 x{STREAM_RATE:g} on "
          f"{STREAM_N} servers, horizon {STREAM_HORIZON:g}: requests "
          f"{s['requests']} segments {s['n_segments']} window_peak "
          f"{s['window_peak']}/{STREAM_WINDOW} events {s['n_events']:.0f} "
          f"loop steps {s['n_loop']:.0f} graph replays {replays} wall "
          f"{wall:.2f} s (capture included) {row['events_per_s']:.4g} "
          f"events/s, {row['ns_step']:.0f} ns a loop step; bound "
          f"{row['bound_ms']:.4f} ms (bytes: {step_bytes} a step); "
          f"budget_exhausted {s['budget_exhausted']}")
    if s["budget_exhausted"] != 0 or s["requests"] <= 0 or replays <= 0:
        raise AssertionError(f"ScenarioStream leg: {s}")
    return row


# -------------------------------------------- phase 9: sweep, fleet, control
def _overloaded_mix():
    """bench_optimality_gap's OVERLOADED_MIX (GAP_CLASSES)."""
    from repro_torch.sweep import MixSpec

    return MixSpec(name="two_class_overloaded", classes=tuple(
        dict(name=nm, prompt_len=p, decode_len=d, arrival_rate=lam,
             patience=th) for nm, p, d, lam, th in GAP_CLASSES))


def _spec_of(d: dict):
    from repro_torch.sweep import SweepSpec

    return SweepSpec.from_dict(d)


def _cpu_sweep_cell(spec_d: dict, mi: int, pi: int) -> list:
    """One (mix, policy, n) cell group of a sweep on the port's CPU
    route, in a worker process: its metric dicts, seed by seed."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    from repro_torch.sweep.evaluators import MixContext
    from repro_torch.sweep.spec import cell_seed_sequence, get_evaluator

    spec = _spec_of(spec_d)
    ctx = MixContext(spec.mixes[mi], spec, device="cpu")
    n = spec.n_servers[0]
    seeds = [cell_seed_sequence(spec, mi, pi, 0, s)
             for s in range(spec.n_seeds)]
    return [c.metrics for c in get_evaluator(spec.evaluator)(
        ctx, spec.policies[pi], n, seeds=seeds)]


def _closed_loop(plans=None, trace_path=None) -> dict:
    """``compare_policies`` on rate_shift (worker process); with
    ``trace_path`` the adaptive replay alone, its trace written."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    from repro_torch.workloads import (ClosedLoopConfig, compare_policies,
                                       run_closed_loop)

    cfg = ClosedLoopConfig(n_servers=CL_N, seed=0)
    t0 = time.perf_counter()
    if trace_path is not None:
        out = run_closed_loop(CL_SCENARIO, "adaptive", cfg,
                              trace_path=trace_path)
    else:
        out = compare_policies(CL_SCENARIO, cfg, variants=CL_VARIANTS,
                               plans=plans)
    return {"out": out, "s": time.perf_counter() - t0}


def _sensitivity_mixes() -> tuple:
    """bench_sensitivity.py's lp grid in full mode, one mix a point."""
    import numpy as np

    from repro_torch.sweep import MixSpec
    from repro_torch.sweep.run import default_mix

    classes = default_mix("two_class").classes

    def mix(name, prim, pricing=None):
        return MixSpec(name=name, classes=classes, prim=prim,
                       pricing=pricing or {})

    out = []
    sweeps = {"B": [4, 8, 16, 24, 32],
              "alpha": list(np.linspace(0.02, 0.15, 8)),
              "beta": list(np.geomspace(1e-5, 1e-3, 8)),
              "gamma": list(np.linspace(10, 50, 8))}
    for key, vals in sweeps.items():
        for v in vals:
            kw = dict(SENS_BASE_PRIM)
            if key == "B":
                kw["batch_cap"] = int(v)
            else:
                kw[key] = float(v)
            out.append(mix(f"{key}={float(v):.6g}", kw))
    for Bv in (4, 8, 16, 32):
        for bv in np.geomspace(1e-5, 5e-4, 4):
            out.append(mix(f"B={Bv}_beta={bv:.6g}",
                           dict(SENS_BASE_PRIM, batch_cap=Bv, beta=bv)))
    for k in (0.15, 0.3, 0.6, 1.2, 2.4):
        for f in np.linspace(0.05, 0.95, 19):
            out.append(mix(f"k={k:g}_f={f:.4f}", dict(SENS_BASE_PRIM),
                           pricing=dict(c_p=f * k, c_d=(1 - f) * k)))
    return tuple(out)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_sweep(torch, smi: str) -> dict:
    """Phase 9: the sweep, fleet and closed-loop layers on the card
    (module docstring); returns ctmc_scan's launches in item (a)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from repro_torch.core.fluid import fluid_final_state
    from repro_torch.core.hetero import FleetSpec, plan_fleet
    from repro_torch.core.planning_batch import solve_plan_jax
    from repro_torch.core.types import Pricing, WorkloadClass
    from repro_torch.kernels.ctmc_scan.ops import ctmc_scan
    from repro_torch.serving import engine_jax as ej
    from repro_torch.sweep import MixSpec, SweepSpec, run_sweep
    from repro_torch.sweep.evaluators import MixContext
    from repro_torch.sweep.fluid_batch import fluid_policy_plan
    from repro_torch.sweep.run import default_mix
    from repro_torch.sweep.run import main as sweep_main
    from repro_torch.telemetry.trace import validate_trace
    from repro_torch.workloads import (ClosedLoopConfig, get_scenario,
                                       plans_for_scenarios)

    print(f"[sweep] card: {smi}")
    times, failures = {}, []
    out_dir = ROOT / "build" / "phase9"
    out_dir.mkdir(parents=True, exist_ok=True)
    het = json.loads(HET_ARTIFACT.read_text())
    # (e)'s spec, as the CLI below builds it from its flags
    cli_spec = SweepSpec(
        name="sweep_engine_jax", evaluator="engine_jax",
        policies=CLI_POLICIES, n_servers=(CLI_N,), n_seeds=CLI_SEEDS,
        seed=0, mixes=tuple(
            MixSpec(name=s, scenario=s, trace=dict(
                horizon=min(CLI_HORIZON, get_scenario(s).horizon)))
            for s in CLI_SCENARIOS),
        horizon=CLI_HORIZON, warmup=30.0,
        extra={"engine_jax": {"fastforward": True}})
    cpu_mi, cpu_pi = CLI_SCENARIOS.index(CLI_CPU_CELL[0]), \
        CLI_POLICIES.index(CLI_CPU_CELL[1])
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
        # the host's work first, so that it overlaps the card's items
        cpu_cell = pool.submit(_cpu_sweep_cell, cli_spec.to_dict(), cpu_mi,
                               cpu_pi)
        cl_simplex = pool.submit(_closed_loop)
        trace_path = out_dir / "closed_loop_rate_shift_adaptive.json"
        cl_trace = pool.submit(_closed_loop, None, str(trace_path))

        # (a) the heterogeneity control through run_sweep, three placements
        n, seeds, horizon, warmup = CONTROL
        spec = SweepSpec(
            name=f"heterogeneity_control_n{n}", evaluator="ctmc_jax",
            policies=("gate_and_route",), n_servers=(n,), n_seeds=seeds,
            seed=0, mixes=(_overloaded_mix(),), horizon=horizon,
            warmup=warmup,
            extra={"crn_policies": True, "ctmc_jax": {"x64": True}})
        ctmc_scan.launches = 0
        res, wall = _timed(torch, lambda: run_sweep(spec))
        launches = ctmc_scan.launches
        times["a vmap"] = wall
        gaps = np.array([c.metrics["gap_pct"] for c in res.cells])
        ev = np.array([c.metrics["n_events"] for c in res.cells])
        t_end = [c.metrics["t_end"] for c in res.cells]
        committed = het["control"]["committed_gap_pct"]
        print(f"[sweep] (a) {spec.name}: {len(res.cells)} cells, ctmc_scan "
              f"launches {launches}, mean gap {gaps.mean()!r}% (ci "
              f"{1.96 * gaps.std() / np.sqrt(len(gaps))!r}) vs committed "
              f"{committed}%; wall {wall:.3f} s, "
              f"{ev.sum() / wall:.4g} events/s and "
              f"{1e9 * wall / ev.max():.1f} ns a step of the longest "
              f"replication ({ev.max():.0f} events), both over the "
              f"sweep's host wall, its plan and set-up included")
        if launches <= 0:
            failures.append("(a) ctmc_scan was never launched")
        if any(t != horizon for t in t_end):
            failures.append(f"(a) a cell stopped short of {horizon}: "
                            f"{min(t_end)}")
        if abs(gaps.mean() - committed) > CONTROL_FLOOR_PCT:
            failures.append(f"(a) mean gap {gaps.mean()} off {committed} "
                            f"by more than {CONTROL_FLOOR_PCT}")
        want = [c.metrics for c in res.cells]
        for label, extra in (
                ("shard_map", {"placement": "shard_map",
                               "shard": {"max_cells_per_device": 8}}),
                ("single", {"placement": "single"})):
            sp = SweepSpec.from_dict(dict(
                spec.to_dict(), extra=dict(spec.extra, **extra)))
            r2, wall = _timed(torch, lambda: run_sweep(sp))
            times[f"a {label}"] = wall
            same = [c.metrics for c in r2.cells] == want
            print(f"[sweep] (a) placement {label} {extra.get('shard', '')}: "
                  f"cells bit for bit the vmap cells: {same}; wall "
                  f"{wall:.3f} s")
            if not same:
                failures.append(f"(a) {label} cells differ from vmap")

        # (b) fleet planning on the card
        def fleets():
            ov = [WorkloadClass(*c) for c in GAP_CLASSES]
            h = plan_fleet(ov, FleetSpec.of([("paper-a100", n)],
                                            xfer_scale=0.0), Pricing())
            hom = solve_plan_jax(ov)
            cl = [WorkloadClass(nm, p, d, FLEET_LAMBDA, th)
                  for nm, p, d, th in FLEET_WORKLOAD]
            rows = [(name, xs, plan_fleet(cl, FleetSpec.of(
                list(fleet), xfer_scale=xs), Pricing(*ES_PRICING)))
                for name, (fleet, xss) in FULL_FLEETS.items()
                for xs in xss]
            return h, hom, rows

        (h, hom, rows), times["b"] = _timed(torch, fleets)
        exact = (float(h.revenue_rate) == float(hom.revenue_rate)
                 and np.array_equal(h.pool_plan(0).x, hom.x))
        print(f"[sweep] (b) one-class paper-a100 fleet, xfer 0: plan_fleet "
              f"R* {float(h.revenue_rate)!r}, solve_plan_jax "
              f"{float(hom.revenue_rate)!r}: degenerate_exact {exact}")
        if not exact:
            failures.append("(b) the one-class fleet is not exact")
        art = {(r["instance"], r["xfer_scale"]): r["R_star"]
               for r in het["rows"]}
        for name, xs, hp in rows:
            got = float(hp.revenue_rate)
            print(f"[sweep] (b) {name} xfer {xs}: R* {got!r} vs the "
                  f"artifact's {art[(name, xs)]}")
            if round(got, 3) != art[(name, xs)]:
                failures.append(f"(b) {name} xfer {xs}: R* {got}")

        # (c) bench_sensitivity's lp grid, the simplex and the card's IPM
        mixes = _sensitivity_mixes()
        cells = {}
        for ev_name in ("lp", "lp_jax"):
            sp = SweepSpec(name="sensitivity", evaluator=ev_name,
                           policies=("lp",), n_servers=(1,), mixes=mixes)
            r, times[f"c {ev_name}"] = _timed(torch, lambda: run_sweep(sp))
            cells[ev_name] = r.cells
        rel = max(abs(a.metrics["revenue"] - b.metrics["revenue"])
                  / abs(a.metrics["revenue"])
                  for a, b in zip(cells["lp"], cells["lp_jax"]))
        conv = all(c.metrics["lp_converged"] == 1.0 for c in cells["lp_jax"])
        print(f"[sweep] (c) {len(mixes)} LPs: max relative revenue "
              f"difference lp_jax vs lp {rel!r}, all converged {conv}; "
              f"lp {times['c lp']:.3f} s, lp_jax {times['c lp_jax']:.3f} s")
        if not (rel <= LP_AGREE and conv):
            failures.append(f"(c) lp_jax vs lp {rel}, converged {conv}")

        # (d) the fluid grid, graphed Euler loop on the card
        two = default_mix("two_class")
        sp = SweepSpec(name="fluid", evaluator="fluid",
                       policies=tuple(FLUID_REF), n_servers=(1,),
                       mixes=(two,), horizon=FLUID_HORIZON)
        r, times["d grid"] = _timed(torch, lambda: run_sweep(sp))
        fctx = MixContext(two, sp)

        def solos():
            out = {}
            for tok in FLUID_REF:
                from repro_torch.core.fluid import fluid_params

                kind, rnd = fluid_policy_plan(tok)
                p = fluid_params(fctx.classes, fctx.prim, fctx.pricing,
                                 fctx.plan(kind), randomized_router=rnd)
                z = torch.zeros_like(p["lam"])
                st, rev = fluid_final_state(
                    p, (z,) * 6, FLUID_DT,
                    n_steps=int(FLUID_HORIZON / FLUID_DT), randomized=rnd)
                out[tok] = (float(rev), st[1].cpu().numpy())
            return out

        solo, times["d solo"] = _timed(torch, solos)
        for c in r.cells:
            m, (rev0, ym0) = c.metrics, FLUID_REF[c.policy]
            s_rev, s_x = solo[c.policy]
            print(f"[sweep] (d) fluid {c.policy}: revenue "
                  f"{m['revenue_rate']!r} (solo {s_rev!r}, reference "
                  f"{rev0}) R* {m['R_star']!r} x_err_l1 {m['x_err_l1']!r} "
                  f"y_err_l1 {m['y_err_l1']!r} (reference {ym0})")
            sx = np.array([m["avg_x/0"], m["avg_x/1"]])
            if not (math.isclose(m["revenue_rate"], s_rev, rel_tol=1e-6)
                    and np.allclose(sx, s_x, rtol=1e-6, atol=0.0)):
                failures.append(f"(d) {c.policy}: grid != solo")
            if not (math.isclose(m["revenue_rate"], rev0, rel_tol=1e-4)
                    and m["x_err_l1"] <= 1e-4
                    and abs(m["y_err_l1"] - ym0) <= 1e-3):
                failures.append(f"(d) {c.policy}: off the reference")
        print(f"[sweep] (d) grid {times['d grid']:.2f} s, solos "
              f"{times['d solo']:.2f} s ({int(FLUID_HORIZON / FLUID_DT)} "
              f"steps each)")

        # (e) trace replay through the sweep CLI
        out = out_dir / f"{cli_spec.name}.json"
        r0, c0 = ej.run.graph_replays, ej.run.graph_captures
        argv = ["--evaluator", "engine_jax", "--scenarios",
                ",".join(CLI_SCENARIOS), "--policies",
                ",".join(CLI_POLICIES), "--ns", str(CLI_N), "--n-seeds",
                str(CLI_SEEDS), "--horizon", str(CLI_HORIZON), "--extra",
                json.dumps(cli_spec.extra), "--name", cli_spec.name,
                "--out", str(out)]
        print(f"[sweep] (e) python -m repro_torch.sweep.run "
              f"{' '.join(argv)}")
        rc, times["e"] = _timed(torch, lambda: sweep_main(argv))
        replays = ej.run.graph_replays - r0
        captures = ej.run.graph_captures - c0
        from repro_torch.sweep import SweepResult

        res = SweepResult.load(out)
        budget = max(c.metrics["budget_exhausted"] for c in res.cells)
        ev = sum(c.metrics["n_events"] for c in res.cells)
        print(f"[sweep] (e) rc {rc}, {len(res.cells)} cells, loop steps "
              f"{replays * ej.BLOCK_STEPS} ({replays} graph replays of "
              f"{ej.BLOCK_STEPS}), graph captures {captures}, events "
              f"{ev:.0f}, budget_exhausted max {budget}, wall "
              f"{times['e']:.2f} s")
        if rc != 0 or budget != 0 or res.spec.to_dict() != \
                cli_spec.to_dict():
            failures.append(f"(e) rc {rc}, budget {budget}, spec "
                            f"{res.spec.to_dict() == cli_spec.to_dict()}")
        mpath = out.with_name(out.stem + ".runs.jsonl")
        chk = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry",
             "validate-manifest", str(mpath)], capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        print(f"[sweep] (e) {chk.stdout.strip()}")
        if chk.returncode != 0:
            failures.append(f"(e) manifest: {chk.stdout} {chk.stderr}")
        card = res.select(mix=CLI_CPU_CELL[0], policy=CLI_CPU_CELL[1])
        host = cpu_cell.result()
        bad = [k for a, b in zip(card, host) for k in a.metrics
               if not (a.metrics[k] == b[k]
                       or (k not in CLI_EXACT and math.isclose(
                           a.metrics[k], b[k], rel_tol=ENGINE_RTOL))
                       or (math.isnan(a.metrics[k]) and math.isnan(b[k])))]
        print(f"[sweep] (e) {CLI_CPU_CELL} on the card vs the CPU route, "
              f"{len(host)} seeds: {'equal' if not bad else bad}")
        if bad or len(card) != len(host):
            failures.append(f"(e) card vs CPU: {bad}")

        # (f) the closed loop: plans on the card, replays on the host
        scn = get_scenario(CL_SCENARIO)
        cfg = ClosedLoopConfig(n_servers=CL_N, seed=0)
        trace = scn.generate(seed=cfg.seed, horizon=cfg.horizon,
                             compression=cfg.compression,
                             rate_scale=cfg.rate_scale)
        (plans,), times["f plans"] = _timed(
            torch, lambda: plans_for_scenarios([scn], [trace], [cfg]))
        card_plans = pool.submit(_closed_loop, plans).result()
        simplex = cl_simplex.result()
        traced = cl_trace.result()
        lead_c = card_plans["out"]["adaptive_lead_pct"]
        lead_s = simplex["out"]["adaptive_lead_pct"]
        errs = validate_trace(trace_path)
        print(f"[sweep] (f) {CL_SCENARIO} n={CL_N}: "
              f"{simplex['out']['n_requests']} requests; adaptive lead "
              f"{lead_s!r}% (simplex plans, {simplex['s']:.2f} s), "
              f"{lead_c!r}% (plans on the card in "
              f"{times['f plans']:.3f} s, replays {card_plans['s']:.2f} s); "
              f"adaptive trace {len(json.loads(trace_path.read_text())['traceEvents'])} "
              f"events, {traced['out']['replans']:.0f} replans, "
              f"valid: {not errs}")
        if lead_s != CL_LEAD or abs(lead_c - CL_LEAD) > 1e-6 or errs:
            failures.append(f"(f) leads {lead_s} / {lead_c}, trace "
                            f"{errs[:3]}")
    if failures:
        raise AssertionError("phase 9: " + "; ".join(failures))
    print("[sweep] wall by item (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    return {"launches": launches}


# ------------------------------------------- phase 10: the rest of A10
# B1 and B2 at every shape phase 10's path gives them, with the stage
# that launches it: (arch, "serve") is the engine's decode (batch cap 4,
# max_len 256; f32 caches promote every dtype to f32), (arch, "whole")
# the whole-prompt prefill step with bf16 caches and the decodes after
# it (whisper-base's f32 weights promote both kernels to f32)
A10_B1 = (  # dtype, B, S, H, KV, D, window, stage
    ("float32", 4, 256, 8, 1, 256, None, ("paligemma-3b", "serve")),
    ("float32", 4, 256, 48, 8, 128, None, ("grok-1-314b", "serve")),
    ("float32", 4, 256, 10, 1, 256, 2048, ("recurrentgemma-2b", "serve")),
    ("bfloat16", 4, 256 + 512 + A10_STEPS, 8, 1, 256, None,
     ("paligemma-3b", "whole")),
    ("float32", 4, 448 + A10_STEPS, 8, 8, 64, None, ("whisper-base", "whole")),
    ("bfloat16", 4, 2048 + A10_STEPS, 48, 8, 128, None,
     ("grok-1-314b", "whole")))
A10_B2 = (  # dtype, B, S, H, KV, D, prefix_len, stage
    ("bfloat16", 4, 768, 8, 1, 256, 256, ("paligemma-3b", "whole")),
    ("bfloat16", 4, 2048, 48, 8, 128, None, ("grok-1-314b", "whole")),
    ("float32", 4, 448, 8, 8, 64, None, ("whisper-base", "whole")))


def _a10_kernels(torch):
    """B1 and B2 at phase 10's shapes (``A10_B1``, ``A10_B2``) against
    their plain versions, full caches; each row keeps its stage."""
    from repro_torch.telemetry.timing import timeit_median_cuda

    def ms(fn):
        return timeit_median_cuda(fn) * 1e3

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(10)

    def rnd(dname, *shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=getattr(torch, dname))

    rows = {"decode_attention": [], "prefill_attention": []}
    for dname, B, S, H, KV, D, window, stage in A10_B1:
        args = (rnd(dname, B, 1, H, D), rnd(dname, B, S, KV, D),
                rnd(dname, B, S, KV, D),
                torch.full((B,), S, dtype=torch.int32, device="cuda"))
        kw = {}
        if window is not None:  # the ring as the engine's local layer holds it
            kw = dict(window=window, q_positions=args[3] - 1,
                      k_positions=torch.arange(
                          S, dtype=torch.int32,
                          device="cuda").expand(B, S).contiguous())
        desc = (f"B={B} S={S} H={H} KV={KV} D={D}"
                + (f" window={window}" if window else "")
                + f" {stage[0]} {stage[1]}")
        row = _decode_row(torch, ms, n_sm, dname, desc, args, kw, B * S)
        row["stage"] = stage
        rows["decode_attention"].append(row)
    for dname, B, S, H, KV, D, prefix_len, stage in A10_B2:
        args = (rnd(dname, B, S, H, D), rnd(dname, B, S, KV, D),
                rnd(dname, B, S, KV, D))
        kw = {"prefix_len": prefix_len} if prefix_len else {}
        desc = (f"B={B} S={S} H={H} KV={KV} D={D}"
                + (f" prefix={prefix_len}" if prefix_len else "")
                + f" {stage[0]} {stage[1]}")
        row = _prefill_row(torch, ms, dname, desc, args, kw)
        row["stage"] = stage
        rows["prefill_attention"].append(row)
    _print_rows(rows, "a10")
    return rows


def _stubs(torch, cfg, B, gen, dtype=None):
    """The stub inputs ``cfg`` takes, drawn from ``gen`` on its device
    (f32 unless ``dtype``): patch embeddings for a prefix-LM, frame
    embeddings for an encoder-decoder."""
    kw = dict(generator=gen, device=gen.device, dtype=dtype or torch.float32)
    out = {}
    if cfg.vision is not None:
        out["prefix_embeds"] = torch.randn(B, cfg.vision.n_patches,
                                           cfg.d_model, **kw)
    if cfg.encoder is not None:
        out["enc_frames"] = torch.randn(B, cfg.encoder.n_frames,
                                        cfg.encoder.d_model, **kw)
    return out


def check_a10(torch, smi: str):
    """Phase 10: paligemma-3b, whisper-base, grok-1 (2 of 64 layers),
    deepseek-v3 (4 of 61) and recurrentgemma-2b at their published widths,
    weights drawn on the card in the config's ``param_dtype``: (a) B1 and
    B2 at their shapes; (b) served through ``serve`` (f32 caches, but
    deepseek-v3's in bf16 through B4; 8 requests); (c) a whole-prompt
    prefill step with bf16 caches and decodes; (d) reduced models on the
    card against the CPU.  Returns (kernel rows, launches of (b) and (c),
    B4's launches in (b))."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    rows = _a10_kernels(torch)
    print(f"[a10] (a) kernels checked in {time.perf_counter() - t0:.1f} s")

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.mla_attention.ops import mla_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    total, stages, served_b4 = {}, {}, 0
    for arch in A10_ARCHS:
        full = get_config(arch)
        cfg = full.replace(n_layers=A10_DEPTH.get(arch, full.n_layers))
        dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" \
            else torch.float32
        n_params = M.param_count(cfg)
        el = torch.finfo(dtype).bits // 8
        print(f"[a10] {arch}: {cfg.n_layers} of {full.n_layers} layers"
              + (" (depth cut: one card)" if cfg.n_layers < full.n_layers
                 else "")
              + f", {n_params} parameters, {n_params * el} bytes in "
              f"{dtype} ({smi})")
        n_attn = _n_attn(cfg)
        if arch in A10_SERVE:
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            cache = A10_CACHE.get(arch)
            mla_attention.launches = 0
            m, served = run_serving(
                torch, arch, cfg=cfg, n_req=A10_REQUESTS, dtype=dtype,
                cache_dtype=getattr(torch, cache) if cache else None)
            b4 = mla_attention.launches
            stages[arch, "serve"] = (served, dict(decode_attention.routes),
                                     prefill_attention.launches_tc,
                                     prefill_attention.launches_fp32)
            mixed = len(m.iter_wall["mixed"])
            iters = mixed + len(m.iter_wall["solo"])
            if served["decode_attention"] != n_attn * iters:
                raise AssertionError(
                    f"serving {arch}: decode_attention launched "
                    f"{served['decode_attention']} times for {iters} "
                    f"iterations x {n_attn} attention layers")
            # a decode every iteration, a chunk every mixed one, each
            # through B4 in every MLA layer where the caches are bf16
            n_mla = _n_mla(cfg) if cache == "bfloat16" else 0
            if b4 != n_mla * (iters + mixed):
                raise AssertionError(
                    f"serving {arch} ({cache or 'float32'} caches): "
                    f"mla_attention launched {b4} times for {iters} "
                    f"iterations ({mixed} mixed) x {n_mla} MLA layers")
            served_b4 += b4
            for k, n in served.items():
                total[k] = total.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[a10] (b) {arch} served {A10_REQUESTS} requests (cut "
                  f"from 24) in {time.perf_counter() - t1:.1f} s: {iters} "
                  f"iterations x {n_attn} attention layers = "
                  f"{served['decode_attention']} B1 launches; {iters} "
                  f"decodes + {mixed} chunks x {_n_mla(cfg)} MLA layers "
                  f"with {cache or 'float32'} caches = {b4} B4 launches; "
                  f"peak allocated {torch.cuda.max_memory_allocated()} "
                  f"bytes")
        if arch in A10_WHOLE:
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            params = M.init_model(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                dtype=dtype, device="cuda")
            torch.cuda.synchronize()
            print(f"[a10] (c) {arch} weights drawn in "
                  f"{time.perf_counter() - t1:.1f} s: "
                  f"{torch.cuda.memory_allocated()} bytes held, peak "
                  f"allocated {torch.cuda.max_memory_allocated()} at the "
                  f"draw")
            B, S = A10_WHOLE[arch]
            _zero_counts()
            counts, by_plan = _whole_prompt(
                torch, cfg, params, B, S, A10_STEPS, tag="a10",
                stubs=_stubs(torch, cfg, B,
                             torch.Generator(device="cuda").manual_seed(4),
                             dtype))
            stages[arch, "whole"] = (counts, by_plan,
                                     prefill_attention.launches_tc,
                                     prefill_attention.launches_fp32)
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            del params
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[a10] (c) {arch} in {time.perf_counter() - t1:.1f} s, "
                  f"peak allocated {torch.cuda.max_memory_allocated()} bytes")

    t1 = time.perf_counter()
    for arch in ("paligemma-3b", "whisper-base", "deepseek-v3-671b",
                 "grok-1-314b"):
        _reduced_matches_cpu(torch, arch, tag="a10")
    print(f"[a10] (d) in {time.perf_counter() - t1:.1f} s")
    for k in ("decode_attention", "prefill_attention"):
        if total.get(k, 0) <= 0:
            raise AssertionError(f"phase 10 never launched {k}")
    # every row of (a) is a shape its stage launched: B1 by its plan (the
    # split of that B, S and head layout) and dtype, B2 by its route
    for r in rows["decode_attention"]:
        r["launches"] = stages[r["stage"]][1].get((r["dtype"], r["plan"]), 0)
    for r in rows["prefill_attention"]:
        counts, _, tc, fp32 = stages[r["stage"]]
        r["launches"] = {"tc": tc, "fp32": fp32}[r["route"]]
        if r["launches"] != counts["prefill_attention"]:
            r["launches"] = 0
    for k, rs in rows.items():
        for r in rs:
            print(f"[a10] {k} {r['dtype']} {r['shape']}: {r['launches']} "
                  f"launches in its stage")
            if r["launches"] <= 0:
                raise AssertionError(f"{k} {r['dtype']} {r['shape']}: its "
                                     f"stage never launched this shape")
    if served_b4 <= 0:
        raise AssertionError("phase 10 never served through mla_attention")
    return rows, total, served_b4


# ---------------------------------------------------------------- phase 11


def _leaf_items(tree):
    """(path, tensor) of every leaf of a dict tree, in sorted-key order."""
    from repro_torch.models.params import tree_flatten
    for path, leaf in tree_flatten(tree):
        yield "/".join(path), leaf


def _grads_close(torch, got, want, rel, what):
    """Every leaf |got - want| <= rel (|want| + max |want|); returns the
    largest error over the leaf's largest magnitude."""
    worst = 0.0
    for (path, g), (_, w) in zip(_leaf_items(got), _leaf_items(want)):
        g, w = g.float().cpu(), w.float().cpu()
        scale = float(w.abs().max())
        err = (g - w).abs()
        if not bool((err <= rel * (w.abs() + scale)).all()):
            raise AssertionError(f"{what}: grad {path} max abs err "
                                 f"{float(err.max())} beyond {rel} x "
                                 f"(|want| + {scale})")
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
    return worst


def _train_window(torch, step_fn, state, batch, n_timed, n_prof, tag, smi):
    """``n_timed`` steps timed on the host clock (each synchronised), then
    ``n_prof`` under ``torch.profiler``, each inside a ``train.step``
    range that ends after a synchronise.  Prints step ms, tokens/s, the
    peak allocated memory (reset before the timed steps), the card's
    busy time a step (its kernels inside the ranges, the tracer's events
    read raw) and its idle share against the untraced step.  Returns the
    state, the losses and ``ssd_scan``'s launches of each step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    tokens = batch["tokens"].numel()
    losses, scans, walls = [], [], []
    torch.cuda.reset_peak_memory_stats()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    started = False
    try:
        for i in range(n_timed + n_prof):
            if i == n_timed:
                prof.start()
                started = True
            n = ssd_scan.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function("train.step"):
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))  # waits for the step
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            scans.append(ssd_scan.launches - n)
    finally:
        if started:
            prof.stop()  # never leave the tracer running
    peak = torch.cuda.max_memory_allocated()
    raw = prof.profiler.kineto_results.events()
    t00 = min(e.start_ns() for e in raw)
    events = [(e.name(), e.device_type(), (e.start_ns() - t00) / 1e3,
               (e.end_ns() - t00) / 1e3) for e in raw]
    kernels = sorted((e[2], e[3]) for e in events
                     if e[1] == DeviceType.CUDA and e[0] != "train.step")
    ranges = sorted((e[2], e[3]) for e in events
                    if e[0] == "train.step" and e[1] == DeviceType.CPU)
    if len(ranges) != n_prof or not kernels:
        raise AssertionError(f"[train] {tag}: the trace holds {len(ranges)} "
                             f"train.step ranges and {len(kernels)} device "
                             f"events")
    busy = _busy_us(kernels, ranges) / 1e3 / n_prof  # ms a step
    span = sum(r1 - r0 for r0, r1 in ranges) / 1e3 / n_prof
    timed = sorted(walls[:n_timed])
    step_ms = 1e3 * timed[len(timed) // 2]
    print(f"[train] {tag}: step ms (median of {n_timed} untraced) "
          f"{step_ms!r}, all {[1e3 * w for w in walls[:n_timed]]!r}; "
          f"tokens/s {tokens / step_ms * 1e3!r} ({tokens} tokens a step); "
          f"peak allocated {peak} bytes; card busy a step {busy!r} ms over "
          f"{n_prof} traced steps ({span!r} ms traced span): idle "
          f"{1 - busy / step_ms!r} of the untraced step, "
          f"{1 - busy / span!r} of the traced one ({smi})")
    return state, losses, scans


def _wall_ms(torch, fn, reps=5):
    """Median host ms of ``fn`` between synchronises, after a warm-up."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return 1e3 * sorted(walls)[reps // 2]


def _ssd_autograd_check(torch):
    """(a) B3 under autograd at mamba2-130m's training shapes against the
    plain version: y and the state at 3b's tolerances, every input grad
    at the kernel's tolerance, one forward launch on the dtype's route."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    from repro_torch.telemetry.timing import timeit_median_cuda

    B, S, H, P, N = TRAIN_SSD
    gen = torch.Generator(device="cuda").manual_seed(11)
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        kind = "tc" if dt == torch.bfloat16 else "fp32"

        def rnd(*shape, dtype=dt, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device="cuda",
                                       dtype=torch.float32).to(dtype)

        ins = [rnd(B, S, H, P), rnd(B, S, N, scale=0.5),
               rnd(B, S, N, scale=0.5),
               -0.1 * rnd(B, S, H, dtype=torch.float32).abs()]
        a = [t.clone().requires_grad_() for t in ins]
        b = [t.clone().requires_grad_() for t in ins]
        n = getattr(ssd_scan, f"launches_{kind}")
        y, h = ssd_scan(*a)
        if getattr(ssd_scan, f"launches_{kind}") != n + 1 \
                or y.grad_fn is None:
            raise AssertionError(f"ssd_scan {dname}: no {kind} launch under "
                                 f"autograd")
        yp, hp = ssd_scan_plain(*b)
        desc = f"B={B} S={S} H={H} P={P} N={N} autograd"
        y_err = _check(torch, "ssd_scan y", y, yp, dname, desc,
                       SSD_Y_TOL[dname])
        h_err = _check(torch, "ssd_scan state", h, hp, "float32", desc)
        gy = rnd(*y.shape)
        gh = rnd(*h.shape, dtype=torch.float32)
        ((y.float() * gy.float()).sum() + (h * gh).sum()).backward()
        ((yp.float() * gy.float()).sum() + (hp * gh).sum()).backward()
        if getattr(ssd_scan, f"launches_{kind}") != n + 1:
            raise AssertionError("ssd_scan's backward launched the kernel")
        g_err = [_check(torch, f"ssd_scan grad {i}", t.grad, w.grad,
                        "float32" if t.dtype == torch.float32 else dname,
                        desc) for i, (t, w) in enumerate(zip(a, b))]
        print(f"[train] (a) ssd_scan {dname} {desc} ({kind}, 1 forward "
              f"launch, backward by the plain version): y err {y_err!r}, "
              f"state err {h_err!r}, input grads err "
              f"{dict(zip(('x', 'B', 'C', 'log_a'), g_err))!r}")

        def fwd_bwd(fn):
            def run():
                xs = [t.detach().requires_grad_() for t in ins]
                torch.autograd.grad(fn(*xs)[0], xs, gy)
            return run

        bytes_, flops = _ssd_work(ins[0], N, torch.finfo(dt).bits // 8,
                                  False)
        bound, by = _bound(dname, bytes_, flops)
        ms = timeit_median_cuda(lambda: ssd_scan(*ins)) * 1e3
        plain_ms = timeit_median_cuda(_graphed(
            torch, lambda: ssd_scan_plain(*ins))) * 1e3
        print(f"[train] (a) ssd_scan {dname} {desc} forward: ms={ms!r} "
              f"plain_ms={plain_ms!r} (CUDA graph) bound_ms={bound!r} "
              f"({by}); forward + backward (host wall, synchronised, "
              f"median of 5): kernel {_wall_ms(torch, fwd_bwd(ssd_scan))!r} "
              f"ms, all plain {_wall_ms(torch, fwd_bwd(ssd_scan_plain))!r} ms")


def _train_batch(torch, cfg, B, S, cursor=0):
    from repro_torch.training import DataConfig, SyntheticLM

    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=B,
                               seq_len=S)).batch_at(cursor)
    return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}


def _train_100m(torch, smi):
    """(b) ``run_training`` on ``preset_100m``: the loss falls, and a run
    resumed from the step-30 checkpoint ends at the same loss."""
    import shutil
    import tempfile

    from repro_torch.launch.train import preset_100m, run_training
    from repro_torch.training import OptConfig, init_train_state, \
        make_train_step

    cfg = preset_100m()
    kw = dict(TRAIN_100M, device="cuda", log_every=10)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        full = run_training(cfg, ckpt_dir=f"{d}/a", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = full["losses"]
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        print(f"[train] (b) preset_100m ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}): {len(losses)} steps "
              f"at batch {kw['batch']} x {kw['seq_len']}, "
              f"{kw['microbatches']} microbatches, checkpoints every "
              f"{kw['ckpt_every']}, in {wall:.1f} s (checkpoints included); "
              f"mean loss of the first 5 {first!r}, of the last 5 {last!r}")
        if not last < first - 0.05:
            raise AssertionError(f"preset_100m: the loss did not fall "
                                 f"({first} -> {last})")
        half = kw["steps"] // 2
        shutil.copytree(f"{d}/a/step_{half:08d}", f"{d}/b/step_{half:08d}")
        shutil.rmtree(f"{d}/a")
        t0 = time.perf_counter()
        resumed = run_training(cfg, ckpt_dir=f"{d}/b", **kw)
        wall = time.perf_counter() - t0
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                losses[half:])]
    print(f"[train] (b) resumed from step {half} in {wall:.1f} s: final "
          f"loss {resumed['final_loss']!r} vs {full['final_loss']!r}, "
          f"largest relative loss difference over steps {half}-"
          f"{kw['steps'] - 1}: {max(rel)!r}")
    if len(resumed["losses"]) != kw["steps"] - half or max(rel) > 1e-4:
        raise AssertionError("preset_100m: the resumed run departs from "
                             "the uninterrupted one beyond 1e-4")
    opt = OptConfig(lr=3e-4, warmup_steps=20, total_steps=kw["steps"])
    state = init_train_state(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), opt, device="cuda")
    step_fn = make_train_step(cfg, opt, microbatches=kw["microbatches"],
                              remat=True)
    batch = _train_batch(torch, cfg, kw["batch"], kw["seq_len"])
    state, _ = step_fn(state, batch)  # warm-up
    _train_window(torch, step_fn, state, batch, 3, 2, "(b) preset_100m",
                  smi)


def _train_full(torch, arch, smi):
    """(c)/(d) ``arch`` at its published width and depth: f32 params,
    activations in the config's ``param_dtype``, ``make_train_step(remat=
    True)``.  Returns ``ssd_scan``'s launches over the steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training.optimizer import opt_init
    from repro_torch.training.train_step import make_loss, value_and_grad

    cfg = get_config(arch)
    B, S, steps = TRAIN_FULL[arch]
    torch.cuda.reset_peak_memory_stats()
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          dtype=torch.float32, device="cuda")
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    state = {"params": params, "opt": opt_init(params, opt)}
    batch = _train_batch(torch, cfg, B, S)
    n_ssm = sum(s.mixer == "ssm" for s in cfg.block_specs())
    print(f"[train] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {M.param_count(cfg)} parameters in f32, "
          f"activations in {cfg.param_dtype}; B={B} S={S}, {steps} steps "
          f"({smi})")
    if n_ssm:
        # step 0's loss and grads through the kernel and all plain
        n, tc = ssd_scan.launches, ssd_scan.launches_tc
        loss, grads = value_and_grad(make_loss(cfg, remat=True), params,
                                     batch)
        if ssd_scan.launches - n != 2 * n_ssm \
                or ssd_scan.launches_tc - tc != 2 * n_ssm:
            raise AssertionError(f"{arch}: ssd_scan launched "
                                 f"{ssd_scan.launches - n} times "
                                 f"({ssd_scan.launches_tc - tc} tc) in a "
                                 f"remat step, expected 2 x {n_ssm} on the "
                                 f"tensor-core route")
        for path, g in _leaf_items(grads):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{arch}: grad {path} not finite")
            if "/ssm/" in path and not bool(g.any()):
                raise AssertionError(f"{arch}: SSM grad {path} is all zero")
        # the same step through the kernel's f32 route, and both all plain
        cfg32 = cfg.replace(param_dtype="float32")
        loss_32, grads_32 = value_and_grad(make_loss(cfg32, remat=True),
                                           params, batch)
        kernel_scan = ssm.ssd_scan
        ssm.ssd_scan = ssd_scan_plain
        try:
            loss_p, grads_p = value_and_grad(make_loss(cfg, remat=True),
                                             params, batch)
            loss_32p, grads_32p = value_and_grad(
                make_loss(cfg32, remat=True), params, batch)
        finally:
            ssm.ssd_scan = kernel_scan
        if ssd_scan.launches - n != 4 * n_ssm:
            raise AssertionError("an all-plain step launched the kernel")

        def l2(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        items = [_leaf_items(t) for t in (grads, grads_p, grads_32,
                                          grads_32p)]
        rows = sorted(((path, l2(g, w), l2(g32, w32), l2(g, g32),
                        l2(w, w32))
                       for (path, g), (_, w), (_, g32), (_, w32)
                       in zip(*items)), key=lambda r: -r[1])
        for path, d16, d32, k32, p32 in rows[:6]:
            print(f"[train] (c) {arch} grad {path}: kernel vs all-plain L2 "
                  f"bf16 {d16!r}, f32 {d32!r}; bf16 from f32: kernel "
                  f"{k32!r}, all-plain {p32!r}")
        d16, d32 = max(r[1] for r in rows), max(r[2] for r in rows)
        print(f"[train] (c) {arch} over all {len(rows)} leaves, kernel vs "
              f"all-plain L2 at most bf16 {d16!r} (limit {TRAIN_BF16_GRAD}),"
              f" f32 {d32!r} (limit {TRAIN_F32_GRAD}); bf16 from f32 at "
              f"most kernel {max(r[3] for r in rows)!r}, all-plain "
              f"{max(r[4] for r in rows)!r}; loss kernel {float(loss)!r}, "
              f"all-plain {float(loss_p)!r} (limit {TRAIN_BF16_LOSS}), f32 "
              f"kernel {float(loss_32)!r}, all-plain {float(loss_32p)!r} "
              f"(limit {TRAIN_F32_LOSS} relative), ln V "
              f"{math.log(cfg.vocab_size)!r}")
        for path, d16, d32, _, _ in rows:
            if d16 > TRAIN_BF16_GRAD or d32 > TRAIN_F32_GRAD:
                raise AssertionError(
                    f"{arch}: grad {path} kernel vs all-plain L2 bf16 {d16} "
                    f"(limit {TRAIN_BF16_GRAD}), f32 {d32} (limit "
                    f"{TRAIN_F32_GRAD})")
        if abs(float(loss) - float(loss_p)) > TRAIN_BF16_LOSS:
            raise AssertionError(f"{arch}: bf16 loss {float(loss)} vs "
                                 f"all-plain {float(loss_p)}")
        if abs(float(loss_32) - float(loss_32p)) > TRAIN_F32_LOSS * abs(
                float(loss_32p)):
            raise AssertionError(f"{arch}: f32 loss {float(loss_32)} vs "
                                 f"all-plain {float(loss_32p)}")
        n_ssm_leaves = sum("/ssm/" in p for p, _ in _leaf_items(grads))
        print(f"[train] (c) {arch} step 0 through the kernel: every grad "
              f"finite, all {n_ssm_leaves} SSM leaves nonzero, the loss "
              f"and every grad leaf within the limits of the all-plain "
              f"step's in bf16 and f32; ssd_scan {2 * n_ssm} launches "
              f"({n_ssm} forward + {n_ssm} recompute) a step, all "
              f"tensor-core in bf16")
        del grads, grads_p, grads_32, grads_32p
    step_fn = make_train_step(cfg, opt, remat=True)
    _zero_counts()
    state, m = step_fn(state, batch)  # warm-up, counted
    scans = [ssd_scan.launches]
    n_prof = 1 if steps <= 4 else 3
    state, losses, more = _train_window(
        torch, step_fn, state, batch, steps - 1 - n_prof, n_prof,
        f"({'c' if n_ssm else 'd'}) {arch}", smi)
    losses = [float(m["loss"])] + losses
    scans += more
    print(f"[train] {arch}: losses {losses!r}"
          + (f"; ssd_scan launches a step (forward + recompute) {scans}"
             if n_ssm else ""))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: a loss is not finite")
    if n_ssm and scans != [2 * n_ssm] * steps:
        raise AssertionError(f"{arch}: ssd_scan launched {scans} times a "
                             f"step, expected {2 * n_ssm}")
    return sum(scans)


def _train_reduced_matches_cpu(torch):
    """(e) One train step's loss and grads of each reduced config on the
    card against the CPU on the same weights, within 1e-4."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    from repro_torch.training.train_step import make_loss, value_and_grad

    for arch in TRAIN_REDUCED:
        cfg = get_config(arch, reduced=True)
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 32)).astype(np.int32))
            for k in ("tokens", "labels")}
        batch.update(_stubs(torch, cfg, 2, torch.Generator().manual_seed(1)))
        out = {}
        for dev in ("cpu", "cuda"):
            out[dev] = value_and_grad(
                make_loss(cfg, remat=True),
                tree_map(lambda a: a.to(dev), params),
                {k: v.to(dev) for k, v in batch.items()})
        (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
        worst = _grads_close(torch, gg, gc, TRAIN_REL, f"reduced {arch}")
        if abs(float(lg) - float(lc)) > TRAIN_REL * abs(float(lc)):
            raise AssertionError(f"reduced {arch}: loss {float(lg)} vs CPU "
                                 f"{float(lc)}")
        print(f"[train] (e) reduced {arch} on the card matches the CPU: "
              f"loss {float(lg)!r} vs {float(lc)!r}, largest grad error "
              f"{worst!r} of the leaf's max (limit {TRAIN_REL})")


def _train_compress(torch):
    """(f) int8 quantisation on the card equal to the CPU's bit for bit;
    the compressed psum over a one-rank NCCL group equal to the same
    over a one-rank gloo group on the CPU."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.training.compress import (dequantize_int8,
                                               make_compressed_psum,
                                               quantize_int8)

    gen = torch.Generator().manual_seed(12)
    xs = [torch.randn(4096, 768, generator=gen),
          1e-3 * torch.randn(50280, generator=gen),
          300.0 * torch.randn(3, 5, 7, generator=gen)]
    for x in xs:
        q, s = quantize_int8(x.cuda())
        qc, sc = quantize_int8(x)
        back, back_c = dequantize_int8(q, s), dequantize_int8(qc, sc)
        if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
                and torch.equal(back.cpu(), back_c)):
            raise AssertionError(f"quantize_int8 {tuple(x.shape)}: the card "
                                 f"differs from the CPU")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=120))
    try:
        gloo = dist.new_group(backend="gloo")
        grads = {"a": xs[0], "b": {"c": xs[1]}}
        res = {"a": 1e-3 * torch.randn(4096, 768, generator=gen),
               "b": {"c": torch.zeros(50280)}}
        to = lambda t, dev: {k: to(v, dev) if isinstance(v, dict)  # noqa
                             else v.to(dev) for k, v in t.items()}
        mean, new_r = make_compressed_psum()(to(grads, "cuda"),
                                             to(res, "cuda"))
        mean_c, new_r_c = make_compressed_psum(gloo)(grads, res)
        for got, want in ((mean, mean_c), (new_r, new_r_c)):
            for (path, g), (_, w) in zip(_leaf_items(got), _leaf_items(want)):
                if not torch.equal(g.cpu(), w):
                    raise AssertionError(f"compressed psum {path}: NCCL on "
                                         f"the card differs from gloo on "
                                         f"the CPU")
    finally:
        dist.destroy_process_group()
    print(f"[train] (f) quantize_int8/dequantize_int8 on the card equal the "
          f"CPU's bit for bit at {[tuple(x.shape) for x in xs]}; the "
          f"compressed psum over a one-rank NCCL group equals a one-rank "
          f"gloo group's on the CPU bit for bit")


def check_train(torch, smi: str) -> int:
    """Phase 11: the training path.  (a) B3 under autograd; (b)
    ``run_training`` on ``preset_100m`` with a resume; (c) mamba2-130m and
    (d) qwen2-0.5b at published width and depth; (e) reduced configs card
    against CPU; (f) int8 compression.  Returns (c)'s ``ssd_scan``
    launches."""
    import gc

    t0 = time.perf_counter()
    _ssd_autograd_check(torch)
    print(f"[train] (a) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _train_100m(torch, smi)
    print(f"[train] (b) in {time.perf_counter() - t0:.1f} s")
    launches = 0
    for arch in TRAIN_FULL:
        t0 = time.perf_counter()
        launches += _train_full(torch, arch, smi)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train] {arch} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _train_reduced_matches_cpu(torch)
    print(f"[train] (e) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _train_compress(torch)
    print(f"[train] (f) in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 12
def _dry_cell(arch: str, shape: str, out_dir: str) -> tuple:
    """One dry-run cell, in a worker process: (record, wall s)."""
    from repro_torch.launch.dryrun import run_cell

    t0 = time.perf_counter()
    rec = run_cell(arch, shape, multi_pod=False, out_dir=Path(out_dir))
    return rec, time.perf_counter() - t0


def _run_example(name: str) -> tuple:
    """``examples/<name>.py`` at its reference defaults (the serving
    example with no arguments): (its output, wall s)."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(*([[]] if name == "torch_serve_cluster" else []))
    return buf.getvalue(), time.perf_counter() - t0


def _decode_32k(torch, smi: str) -> tuple:
    """Phase 12 (b): qwen2-0.5b at its published width, bf16 params and
    caches, through ``make_decode_step(masked=False)`` at decode_32k's
    S=32768 over full random caches, at the largest batch of
    ``DECODE_32K_BATCHES`` whose state and the copy of it that the
    ``masked=True`` twin writes fit.  Returns (B1 row, launches)."""
    import gc

    from repro_torch.compat import make_mesh
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.roofline import hw_constants
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_flatten, tree_map
    from repro_torch.serving.steps import make_decode_step
    from repro_torch.telemetry.timing import timeit_median_cuda

    def ms(fn):
        return timeit_median_cuda(fn) * 1e3

    cfg = get_config(ARCH)
    S = SHAPES["decode_32k"].seq_len
    n_attn = _n_attn(cfg)
    H, KV, D = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    gen = torch.Generator(device="cuda").manual_seed(32)
    params = M.init_model(cfg, gen, torch.bfloat16, "cuda")
    unmasked, masked = make_decode_step(cfg, masked=False), \
        make_decode_step(cfg)
    for B in DECODE_32K_BATCHES:
        state = out = twin = None
        torch.cuda.reset_peak_memory_stats()
        try:
            caches = M.init_cache(cfg, B, S, torch.bfloat16, "cuda")
            for path, leaf in tree_flatten(caches):
                if path[-1] == "pos":  # slot i holds position i
                    leaf.copy_(torch.arange(S, dtype=torch.int32,
                                            device="cuda").expand_as(leaf))
                else:
                    leaf.normal_(generator=gen)
            state = {"caches": caches,
                     "length": torch.full((B,), S - 1, dtype=torch.int32,
                                          device="cuda"),
                     "last_token": torch.randint(
                         2, cfg.vocab_size, (B,), generator=gen,
                         device="cuda", dtype=torch.int32),
                     "active": torch.ones(B, dtype=torch.bool,
                                          device="cuda")}
            _zero_counts()
            # the steps write the caches they are given: the twin writes
            # a copy of the state, the unmasked step the state itself
            twin = masked(params, tree_map(torch.clone, state))
            torch.cuda.synchronize()
            out = unmasked(params, state)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            pass
        # outside the handler, so the traceback's frames are gone
        state = out = twin = caches = None
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[dry] (b) B={B} at S={S} does not fit one card")
    else:
        raise AssertionError("phase 12 (b): no batch fits")
    launches = decode_attention.launches
    routes = dict(decode_attention.routes)
    if launches != 2 * n_attn:
        raise AssertionError(f"phase 12 (b): B1 launched {launches} times "
                             f"for 2 steps x {n_attn} attention layers")
    (new, tok), (new_m, tok_m) = out, twin
    # a layer at a time: a whole leaf's temporaries would not fit
    same = torch.equal(tok, tok_m) and all(
        pa == pb and a.shape == b.shape
        and all(torch.equal(x, y) for x, y in zip(a, b))
        for (pa, a), (pb, b) in zip(tree_flatten(new), tree_flatten(new_m)))
    if not same:
        raise AssertionError("phase 12 (b): masked=False's new state "
                             "differs from masked=True's with every slot "
                             "active")
    if not all(bool(torch.isfinite(x).all()) for _, leaf in
               tree_flatten(new["caches"]) if leaf.is_floating_point()
               for x in leaf):
        raise AssertionError("phase 12 (b): non-finite caches")
    print(f"[dry] (b) {ARCH} decode B={B} S={S} (the largest of "
          f"{DECODE_32K_BATCHES} whose state and the twin's copy fit), "
          f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB: B1 {launches} launches = 2 steps x {n_attn} layers "
          f"({_b1_routes()}); masked=False's state equals masked=True's "
          f"bit for bit")
    del new_m, tok_m, twin, out, new, tok
    gc.collect()
    torch.cuda.empty_cache()
    # a step queues more kernels than the card's launch queue holds, so
    # its reps are queued behind the spin as replays of one CUDA graph
    replay = _graphed(torch, lambda: unmasked(params, state))
    step_ms = ms(replay)
    del replay
    hw = hw_constants("h100")
    rec = analyze_cell(get_config(ARCH), "decode_32k",
                       make_mesh((1, 1), ("data", "model")), strategy={},
                       global_batch=B)
    ex = rec["extrapolated"]
    mem_ms = ex["bytes"] / hw["hbm_bw"] * 1e3
    ideal_ms = rec["memory"]["argument_bytes"] / hw["hbm_bw"] * 1e3
    print(f"[dry] (b) step device ms {step_ms!r} (median of 5 replays of "
          f"its CUDA graph, spin-queued) "
          f"beside the dry run's memory term {mem_ms!r} ms ({ex['bytes']!r} "
          f"bytes) and its state streamed once {ideal_ms!r} ms "
          f"(argument bytes {rec['memory']['argument_bytes']}), compute "
          f"term {ex['flops'] / hw['peak_flops_bf16'] * 1e3!r} ms, at the "
          f"H100 SXM's table ({smi})")
    del state, caches
    gc.collect()
    torch.cuda.empty_cache()
    # B1 at this shape against its plain version
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    args = (torch.randn(B, 1, H, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16),
            torch.randn(B, S, KV, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16),
            torch.randn(B, S, KV, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16),
            torch.full((B,), S, dtype=torch.int32, device="cuda"))
    row = _decode_row(torch, ms, n_sm, "bfloat16",
                      f"B={B} S={S} decode_32k", args, {}, B * S)
    row["launches"] = routes.get(("bfloat16", row["plan"]), 0)
    if row["launches"] != launches:
        raise AssertionError(f"phase 12 (b): B1's plan at the checked shape "
                             f"is not the step's: {routes}")
    _print_rows({"decode_attention": [row]}, "dry")
    return row, launches


def check_dryrun(torch, smi: str) -> tuple:
    """Phase 12: (a) the dry run over the single-pod mesh's 40 cells in
    worker processes, the roofline at the card's table and the perf loop;
    (b) qwen2-0.5b's decode at S=32768 through ``make_decode_step(
    masked=False)``; (c) the six examples at their reference defaults.
    Returns (B1 row, B1 launches, ctmc_scan launches)."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.kernels.ctmc_scan.ops import ctmc_scan
    from repro_torch.launch import perf_loop
    from repro_torch.launch.roofline import (hw_constants, load_records,
                                             render_table, roofline_terms)

    hw = hw_constants("h100")
    ctx = multiprocessing.get_context("spawn")
    workers = max(2, min(7, (os.cpu_count() or 2) - 1))
    # the costliest cells first, so the pool ends together
    order = {"prefill_32k": 0, "train_4k": 1, "decode_32k": 2, "long_500k": 3}
    cells = sorted(((a, s) for a in ARCHS for s in SHAPES),
                   key=lambda c: order[c[1]])
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx) as pool:
        t0 = time.perf_counter()
        host = {nm: pool.submit(_run_example, nm) for nm in HOST_EXAMPLES}
        dry = {c: pool.submit(_dry_cell, *c, tmp) for c in cells}
        # (b) and the card's examples while the pool traces
        t1 = time.perf_counter()
        row, b1 = _decode_32k(torch, smi)
        print(f"[dry] (b) in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        ctmc = 0
        for nm in CARD_EXAMPLES:
            _zero_counts()
            ctmc_scan.launches = 0
            text, wall = _run_example(nm)
            counts = {**_counts(), "ctmc_scan": ctmc_scan.launches}
            for ln in text.splitlines():
                print(f"[dry] (c) {nm}: {ln}")
            print(f"[dry] (c) {nm} on the card in {wall:.1f} s; launches "
                  f"{counts}")
            if nm == "torch_ctmc_jax_demo":
                ctmc = counts["ctmc_scan"]
            if nm == "torch_serve_cluster":
                b1 += counts["decode_attention"]
            need = {"torch_ctmc_jax_demo": "ctmc_scan",
                    "torch_serve_cluster": "decode_attention"}.get(nm)
            if need and counts[need] <= 0:
                raise AssertionError(f"phase 12 (c): {nm} never launched "
                                     f"{need}")
        print(f"[dry] (c) card examples in {time.perf_counter() - t1:.1f} s")
        recs = {}
        for (a, s), fut in dry.items():
            rec, wall = fut.result()
            recs[a, s] = rec
            if "skipped" in rec:
                print(f"[dry] (a) {a} x {s}: {wall:.2f} s SKIP "
                      f"{rec['skipped']}")
                continue
            if not rec.get("ok"):
                raise AssertionError(f"phase 12 (a): {a} x {s} failed: "
                                     f"{rec.get('error')}\n"
                                     f"{rec.get('traceback')}")
            ex = rec["extrapolated"]
            t = roofline_terms(rec, hw)
            print(f"[dry] (a) {a} x {s}: {wall:.2f} s, flops "
                  f"{ex['flops_global']:.6e} global / {ex['flops']:.6e} a "
                  f"device, bytes {ex['bytes_global']:.6e} / "
                  f"{ex['bytes']:.6e}, coll {ex['coll_total']:.6e} B a "
                  f"device, argument "
                  f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB a "
                  f"device, dominant {t['dominant']}")
        n_ok = sum(bool(r.get("ok")) for r in recs.values())
        skips = {c for c, r in recs.items() if "skipped" in r}
        print(f"[dry] (a) 40 cells in {time.perf_counter() - t0:.1f} s on "
              f"{workers} workers: {n_ok} ok, {len(skips)} skipped")
        if n_ok != DRY_OK or len(skips) != DRY_SKIPS or any(
                recs[c]["skipped"] != DRY_SKIP or c[1] != "long_500k"
                for c in skips):
            raise AssertionError(f"phase 12 (a): {n_ok} ok and skips "
                                 f"{sorted(skips)}; expected {DRY_OK} ok and "
                                 f"{DRY_SKIPS} long_500k skips")
        for ln in render_table(load_records(Path(tmp)), hw).splitlines():
            print(f"[dry] (a) {ln}")
        t1 = time.perf_counter()
        arch, shape, strategies = PERF_LOOP
        perf_loop.main(["--arch", arch, "--shape", shape, "--strategies",
                        strategies, "--hw", "h100", "--out", tmp])
        print(f"[dry] (a) perf loop in {time.perf_counter() - t1:.1f} s")
        for nm, fut in host.items():
            text, wall = fut.result()
            for ln in text.splitlines():
                print(f"[dry] (c) {nm}: {ln}")
            print(f"[dry] (c) {nm} on the host in {wall:.1f} s")
    return row, b1, ctmc


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

    # 8. trace-replay engines
    t0 = time.perf_counter()
    check_engine(torch)
    print(f"[engine] phase 8 in {time.perf_counter() - t0:.1f} s")

    # 9. the sweep, fleet and closed-loop layers
    t0 = time.perf_counter()
    sweep_row = check_sweep(torch, smi)
    print(f"[sweep] phase 9 in {time.perf_counter() - t0:.1f} s ({smi})")

    # 10. the rest of the data plane: prefix-LM, encoder, MLA, MoE
    t0 = time.perf_counter()
    a10_rows, a10_launches, launches["mla_attention"] = check_a10(torch, smi)
    for k, rs in a10_rows.items():
        rows[k] += rs
        launches[k] += a10_launches[k]
    print(f"[a10] phase 10 in {time.perf_counter() - t0:.1f} s ({smi})")

    # 11. the training path
    t0 = time.perf_counter()
    launches["ssd_scan"] += check_train(torch, smi)
    print(f"[train] phase 11 in {time.perf_counter() - t0:.1f} s ({smi})")

    # 12. the dry run, the decode at S=32768 and the examples
    t0 = time.perf_counter()
    dry_row, dry_b1, dry_ctmc = check_dryrun(torch, smi)
    rows["decode_attention"].append(dry_row)
    launches["decode_attention"] += dry_b1
    print(f"[dry] phase 12 in {time.perf_counter() - t0:.1f} s ({smi})")

    # the shape of each kernel's main path stands for it in the line:
    # B1's and B3's calibration and engine calls, B2's grok-cell chunk
    main_shape = {"decode_attention": "B=16 S=512 main",
                  "prefill_attention": "C=512 kv_len=2048 H=48 KV=8 D=128 "
                                       "grok chunk softcap=30",
                  "ssd_scan": "B=1 S=16 H=24 engine chunk",
                  "mla_attention": "B=64 S=8192 H=128 decode, lengths "
                                   "1..8192"}
    sources = {"decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:79"),
        "prefill_attention": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention/kernel.py:93"),
        "ssd_scan": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:68"),
        "mla_attention": (
        "src/repro_torch/kernels/csrc/mla_attention.cu",
        "none: src/repro/models/mla.py attends with jnp.einsum")}
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
                 "main_bound_by": gap_row["main_bound_by"],
                 # phase 9's own path (the heterogeneity control sweep)
                 "launches_phase9": sweep_row["launches"],
                 # phase 12's ctmc_jax_demo
                 "launches_phase12": dry_ctmc})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
