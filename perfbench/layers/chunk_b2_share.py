"""Kernels (B2, ``csrc/prefill_attention.cu``): the continuation chunks'
attention calls that ran through B2 over the cache up to the chunk's end,
over all continuation attention calls, in percent, from the program's
counter (``repro_torch.telemetry.counters``; the rest ran the blockwise
path over the whole cache). The counter adds up only while
``torch.profiler`` runs, so it covers the traced iterations, and is read
once the window has closed. None for a model without attention layers
(``attn``, ``attn_local``) and where the program has no such counter; 0
for an attention model whose counter counted nothing."""


def read(run):
    pattern = run.cfg["model"].get("pattern", ["attn"])
    if not set(pattern) & {"attn", "attn_local"}:
        return None
    try:
        from repro_torch.telemetry import counters
        tot = counters.chunk_totals()
    except (ImportError, AttributeError):
        return None
    n = tot["b2"] + tot["blockwise"]
    return 100.0 * tot["b2"] / n if n else 0.0
