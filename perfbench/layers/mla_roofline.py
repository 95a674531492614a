"""Kernels (``kernels/csrc/mla_attention.cu``, B4): over the traced
iterations, the least time B4's calls could take
(``roofline/mla_attention.py``) over B4's device time, in percent.

Every traced iteration runs one decode in each MLA layer, at every slot's
length before it plus its new token; a mixed iteration also runs its
chunk there, counted at its (first position, real tokens) over the
``kv_len`` the engine gives it (the chunk's first position plus the
serving chunk). A call launches ``mla_attend_kernel`` once, after
``mla_stats_kernel`` and, when the decode is split, before
``mla_combine_kernel``; B4's time is all three. None for a model without
MLA layers, and unless the trace holds one ``mla_attend_kernel`` for each
call the iterations should have made: the reading is also the witness
that the serving path attended through B4 alone."""

import numpy as np

from perfbench.roofline import mla_attention as b4

CALL = "mla_attend_kernel"
KERNELS = ("mla_stats_kernel", CALL, "mla_combine_kernel")


def read(run):
    m = run.cfg["model"]
    a = m.get("mla")
    pattern = m.get("pattern", ["attn"])
    if run.peaks is None or a is None:
        return None
    layers = sum(pattern[i % len(pattern)] == "mla"
                 for i in range(m["n_layers"]))
    its = [it for it in run.rec.iterations if it.lengths is not None]
    ev = [(n, t0, t1) for n, t0, t1 in run.events["kernels"]
          if any(k in n for k in KERNELS)]
    calls = sum(CALL in n for n, _, _ in ev)
    if not layers or not its \
            or calls != layers * sum(1 + (it.chunk is not None)
                                     for it in its):
        return None
    sv = run.cfg["serving"]
    S = sv["max_len"]
    el = 2 if sv["cache_dtype"] == "bfloat16" else 4
    H, r, e = a["n_heads"], a["kv_lora_rank"], a["qk_rope_dim"]
    bound = 0.0
    for it in its:
        lens = np.minimum(np.asarray(it.lengths) + 1, S)
        bound += b4.bound_s(b4.decode_work(lens, H, r, e, el), run.peaks)
        if it.chunk is not None:
            first, n = it.chunk
            kv = min(first + sv["chunk"], S)
            bound += b4.bound_s(b4.chunk_work(first, n, kv, H, r, e, el),
                                run.peaks)
    busy = sum(t1 - t0 for _, t0, t1 in ev) / 1e6
    return 100.0 * layers * bound / busy
