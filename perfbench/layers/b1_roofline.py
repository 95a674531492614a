"""Kernels (``kernels/csrc/decode_attention.cu``, B1): over the traced
iterations, the least time B1's calls could take at every row's real
``kv_len`` (``roofline/decode_attention.py``) over B1's device time, in
percent. B1 runs once per layer in every iteration, at the lengths the
slots hold before it."""

import numpy as np

from perfbench.roofline import decode_attention as b1

KERNEL = "decode_kernel"


def read(run):
    a = run.cfg["model"].get("attn")
    if run.peaks is None or a is None:
        return None
    calls = [(n, t0, t1) for n, t0, t1 in run.events["kernels"]
             if KERNEL in n]
    lens = [it.lengths for it in run.rec.iterations
            if it.lengths is not None]
    L = run.cfg["model"]["n_layers"]
    if not calls or len(calls) != L * len(lens):
        return None
    S = run.cfg["serving"]["max_len"]
    el = 2 if run.cfg["serving"]["cache_dtype"] == "bfloat16" else 4
    bound = L * sum(b1.bound_s(np.minimum(np.asarray(x) + 1, S),
                               a["n_heads"], a["n_kv_heads"], a["head_dim"],
                               el, run.peaks) for x in lens)
    busy = sum(t1 - t0 for _, t0, t1 in calls) / 1e6
    return 100.0 * bound / busy
