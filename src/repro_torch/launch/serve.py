"""End-to-end serving: gate-and-route over real-compute engines.

Plans with the paper's LP, partitions servers mixed/solo, replays a
synthesized two-class trace through
:class:`repro_torch.serving.cluster.RealCluster` (actual prefill/decode
compute + real state migration), and prints the revenue/latency summary.
Weights are random, drawn from ``--seed``.

Usage (the default arch is qwen2-0.5b; as in the reference, ``main``
serves the reduced config, while ``serve(get_config(arch))`` takes any
config, full width included):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..compat import resolve_device
from ..configs import ARCHS, get_config
from ..core.planning import solve_bundled_lp
from ..core.types import Pricing, ServicePrimitives, WorkloadClass
from ..models import model as M
from ..models.config import ModelConfig
from ..serving.cluster import ClusterMetrics, RealCluster

__all__ = ["serve", "main"]


def serve(cfg: ModelConfig, *, servers: int = 4, requests: int = 24,
          batch_cap: int = 4, chunk: int = 16, rate: float = 2.0,
          seed: int = 0, device=None,
          dtype=torch.float32) -> ClusterMetrics:
    """Plan, build ``servers`` engines over random weights from ``seed``,
    replay ``requests`` arrivals at ``rate``/s and return the metrics.

    The weights are drawn in ``dtype``: f32 by default, as the
    reference's ``serve`` draws them; ``chip_smoke.py`` passes a config's
    ``param_dtype`` so that the MoE configs' weights fit one card.  The
    caches are f32 either way, as the reference's."""
    device = resolve_device(device)
    prim = ServicePrimitives(batch_cap=batch_cap, chunk=chunk)
    pricing = Pricing()
    classes = [
        WorkloadClass("code", prompt_len=48, decode_len=12,
                      arrival_rate=rate / 2 / servers, patience=0.1),
        WorkloadClass("conversation", prompt_len=12, decode_len=32,
                      arrival_rate=rate / 2 / servers, patience=0.1),
    ]
    plan = solve_bundled_lp(classes, prim, pricing)
    print(f"LP plan: x*={np.round(plan.x, 4)} "
          f"mixed={plan.mixed_servers(servers)}/{servers} "
          f"R*={plan.revenue_rate:.3f}/server/s")

    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_model(cfg, gen, dtype=dtype, device=device)
    cluster = RealCluster(cfg, params, classes, plan, prim, pricing,
                          n_servers=servers, max_len=256, seed=seed,
                          device=device)
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for _ in range(requests):
        t += rng.exponential(1.0 / rate)
        c = int(rng.integers(len(classes)))
        P = classes[c].prompt_len
        toks = rng.integers(2, cfg.vocab_size, size=P).astype(np.int32)
        reqs.append((t, c, toks, classes[c].decode_len))
    return cluster.run(reqs, horizon=t + 1000.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch-cap", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="total arrivals/s across classes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    metrics = serve(get_config(args.arch, reduced=True),
                    servers=args.servers, requests=args.requests,
                    batch_cap=args.batch_cap, chunk=args.chunk,
                    rate=args.rate, seed=args.seed, device=args.device)
    for k, v in metrics.summary().items():
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
