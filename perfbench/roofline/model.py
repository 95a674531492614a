"""Model FLOPs of one engine iteration of an attention + MoE model,
counted from shapes as the useful work: every matmul weight a served
token touches (its k routed experts, not all E), attention over each
token's real causal context, and the output head only where a logit is
used (every decode token, the last position of a prefill chunk)."""

__all__ = ["token_flops", "iteration_flops"]


def _dims(model: dict):
    a, e = model["attn"], model["moe"]
    return (model["n_layers"], model["d_model"], a["n_heads"],
            a["n_kv_heads"], a["head_dim"], e["n_experts"], e["top_k"],
            e["d_ff_expert"], model["vocab_size"])


def token_flops(model: dict, ctx: int, head: bool) -> float:
    """FLOPs of one token at context ``ctx`` (keys it attends to)."""
    L, d, H, KV, D, E, k, F, V = _dims(model)
    per_layer = 2 * d * (2 * H * D + 2 * KV * D)  # q, o, k, v
    per_layer += 2 * d * E + k * 3 * 2 * d * F  # router, k experts
    per_layer += 4 * H * D * ctx  # scores and weighted sum
    return L * per_layer + (2 * d * V if head else 0)


def iteration_flops(model: dict, decode_ctx, chunk) -> float:
    """decode_ctx: the context of each decode token the iteration served;
    chunk: (first position, real tokens) of its prefill chunk, or None."""
    f = sum(token_flops(model, c, True) for c in decode_ctx)
    if chunk is not None:
        p0, n = chunk
        L, d, H, KV, D, E, k, F, V = _dims(model)
        f += n * token_flops(model, 0, False) + 2 * d * V
        f += L * 4 * H * D * sum(range(p0 + 1, p0 + n + 1))
    return f
