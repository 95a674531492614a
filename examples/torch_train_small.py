"""Train a ~100M-parameter dense LM for a few hundred steps with the
PyTorch port, with checkpoint/restart (kill it mid-run and re-run: it
resumes from the last checkpoint, including the data cursor).  On the
CUDA card by default; ``--device cpu`` for the CPU, ``--reduced`` for a
two-layer cut of the preset.

Run:  PYTHONPATH=src python examples/torch_train_small.py
      PYTHONPATH=src python examples/torch_train_small.py --reduced \\
          --steps 20 --device cpu
"""

import argparse

from repro_torch.launch.train import preset_100m, run_training


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_100m_torch")
    ap.add_argument("--reduced", action="store_true",
                    help="2 layers, d_model 64, vocab 512")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = preset_100m()
    if args.reduced:
        cfg = cfg.replace(n_layers=2, d_model=64, d_ff=128, vocab_size=512)
    out = run_training(
        cfg,
        steps=args.steps,
        batch=8,
        seq_len=256,
        microbatches=2,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        device=args.device,
    )
    first, last = out["losses"][0], out["final_loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {len(out['losses'])} steps")
    return out


if __name__ == "__main__":
    main()
