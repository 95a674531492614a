"""How far a bf16-activation train step's grads lie from the f32 step's,
in the JAX reference and in the port, on the same weights and batch.

For each grad leaf it prints four relative L2 distances: the
reference's bf16 step from its f32 step, the port's bf16 step from its
f32 step, the port's bf16 step from the reference's, and the port's f32
step from the reference's.  The first is the reference's own bf16
noise: the yardstick for the port's bf16 training path.  CPU only.

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_bf16_grad_gap.py
          --arch mamba2-130m --reduced
      PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_bf16_grad_gap.py
          --arch mamba2-130m --layers 16

``--reduced`` takes the reduced config at B=2 S=32.  Otherwise the
config keeps its published widths at B=1 S=1024, and only the depth
(``--layers``) and the SSD chunk (to 64 tokens) are cut: at
mamba2-130m's own 256-token chunk the reference's SSM grads are NaN
(ROADMAP C-ref9).  The batch is the training tests' (``_batch`` of
``tests/test_torch_training.py``): numpy draws from seed 0, the first
three labels masked.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import training as RT
from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.models.params import params_from_numpy
from repro_torch.training.train_step import make_loss, value_and_grad

WIDE = dict(B=1, S=1024, chunk=64)
KEYS = ("ref16_vs_ref32", "port16_vs_port32", "port16_vs_ref16",
        "port32_vs_ref32")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def grad_gaps(rcfg, cfg, B, S, seed=0):
    """(losses, rows) of the reference's config ``rcfg`` and its twin
    ``cfg`` in the port: the four steps' losses, and per grad leaf its
    path and the four distances of ``KEYS``."""
    rp = jax.tree.map(np.asarray, RM.init_model(rcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    losses, grads = {}, {}
    for dt in ("float32", "bfloat16"):
        rc = rcfg.replace(param_dtype=dt)
        losses["ref", dt], grads["ref", dt] = jax.jit(jax.value_and_grad(
            lambda p: RT.make_loss(rc, remat=False)(p, jb)))(rp)
        losses["port", dt], grads["port", dt] = value_and_grad(
            make_loss(cfg.replace(param_dtype=dt), remat=False),
            params_from_numpy(rp, "cpu"), tb)
    rows = []
    for path, r32 in jax.tree_util.tree_leaves_with_path(
            grads["ref", "float32"]):
        r16 = _at(grads["ref", "bfloat16"], path)
        p16 = _at(grads["port", "bfloat16"], path).numpy()
        p32 = _at(grads["port", "float32"], path).numpy()
        rows.append((jax.tree_util.keystr(path),
                     dict(zip(KEYS, (_rel(r16, r32), _rel(p16, p32),
                                     _rel(p16, r16), _rel(p32, r32))))))
    return {k: float(v) for k, v in losses.items()}, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config, B=2 S=32")
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args(argv)
    if args.reduced:
        rcfg = ref_get_config(args.arch, reduced=True)
        cfg = get_config(args.arch, reduced=True)
        B, S = 2, 32
    else:
        rcfg, cfg = (get(args.arch) for get in (ref_get_config, get_config))
        B, S = WIDE["B"], WIDE["S"]
        over = dict(n_layers=args.layers, max_seq_len=S)
        rcfg, cfg = rcfg.replace(**over), cfg.replace(**over)
        if cfg.ssm is not None:
            rcfg = rcfg.replace(ssm=dataclasses.replace(
                rcfg.ssm, chunk=WIDE["chunk"]))
            cfg = cfg.replace(ssm=dataclasses.replace(
                cfg.ssm, chunk=WIDE["chunk"]))
    losses, rows = grad_gaps(rcfg, cfg, B, S)
    print(f"{args.arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, chunk "
          f"{cfg.ssm.chunk if cfg.ssm else None}; B={B} S={S}")
    print("losses", losses)
    for path, d in rows:
        print(f"  {path:40s} " + " ".join(f"{k}={v!r}" for k, v in d.items()))
    print("largest", {k: max(d[k] for _, d in rows) for k in KEYS})


if __name__ == "__main__":
    main()
