"""End-to-end training entry point with checkpoint/restart.

The reference's ``launch/train``: runs real compute (reduced configs or
the ~100M preset) with resume-from-checkpoint (step, optimizer state,
data cursor) and gradient accumulation, on the card unless ``device``
(``--device``) asks for the CPU.  Prints as the reference does.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..compat import resolve_device
from ..configs import ARCHS, get_config
from ..models.config import AttentionConfig, ModelConfig
from ..training import (DataConfig, OptConfig, SyntheticLM,
                        init_train_state, make_train_step)

__all__ = ["preset_100m", "run_training", "main"]


def preset_100m() -> ModelConfig:
    """~100M-param dense LM for the end-to-end example."""
    return ModelConfig(
        name="repro-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        d_ff=2048,
        vocab_size=8192,
        attn=AttentionConfig(n_heads=12, n_kv_heads=4, head_dim=64),
        pattern=("attn",),
        max_seq_len=1024,
    )


def run_training(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
                 ckpt_dir: str | None, ckpt_every: int = 50,
                 microbatches: int = 1, log_every: int = 10,
                 seed: int = 0, opt: OptConfig | None = None,
                 device=None) -> dict:
    """Train ``cfg`` from random weights (from ``seed``), or resume from
    the latest checkpoint under ``ckpt_dir``, up to ``steps`` steps of
    ``batch`` x ``seq_len`` tokens; checkpoint every ``ckpt_every`` steps
    and at the end.  Returns the losses of the steps this call ran and
    the final loss."""
    device = resolve_device(device)
    opt = opt or OptConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=batch,
                      seq_len=seq_len, seed=seed)
    ds = SyntheticLM(dcfg)
    step_fn = make_train_step(cfg, opt, microbatches=microbatches,
                              remat=True)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    cursor = 0
    if mgr is not None and mgr.latest_step() is not None:
        state, meta = mgr.restore(device=device)
        cursor = meta.get("cursor", 0)
        print(f"resumed from step {mgr.latest_step()} (cursor={cursor})")
    else:
        state = init_train_state(
            cfg, torch.Generator(device=device).manual_seed(seed), opt,
            device=device)

    losses = []
    t0 = time.time()
    start = int(state["opt"]["step"])
    for it in range(start, steps):
        batch_np = ds.batch_at(cursor)
        cursor += 1
        state, metrics = step_fn(
            state, {k: torch.from_numpy(v).to(device)
                    for k, v in batch_np.items()})
        losses.append(float(metrics["loss"]))
        if it % log_every == 0 or it == steps - 1:
            tok_s = (batch * seq_len * (it - start + 1)) / max(
                time.time() - t0, 1e-9)
            print(f"step {it:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} tok/s {tok_s:,.0f}",
                  flush=True)
        if mgr is not None and (it + 1) % ckpt_every == 0:
            mgr.save(it + 1, state, metadata={"cursor": cursor})
    if mgr is not None:
        mgr.save(steps, state, metadata={"cursor": cursor})
    return {"losses": losses, "final_loss": losses[-1] if losses else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--preset", default=None, choices=["100m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.preset == "100m":
        cfg = preset_100m()
    elif args.arch:
        cfg = get_config(args.arch, reduced=args.reduced)
    else:
        raise SystemExit("need --arch or --preset")
    out = run_training(cfg, steps=args.steps, batch=args.batch,
                       seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                       microbatches=args.microbatches, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
