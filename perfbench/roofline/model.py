"""Model FLOPs of one engine iteration, counted from the configuration's
shapes as the useful work: every matmul weight a served token touches,
attention over each token's real causal context, and the output head only
where a logit is used (every decode token, the last position of a prefill
chunk). A multiply-add is 2 FLOPs; norms, rope, softmax, gates and the
training-only MTP head are not counted.

Rules, a token and a layer (d = ``d_model``):

- ``attn``/``attn_local`` (``attn``: H heads, KV heads, head size D): the
  q, k, v and o projections 2·d·(2·H·D + 2·KV·D); scores and weighted sum
  4·H·D a key. An ``attn_local`` layer attends at most ``window`` keys.
- ``mla`` (H heads, q rank rq, kv rank r, ``qk_nope_dim`` n,
  ``qk_rope_dim`` e, ``v_head_dim`` v): projections once a token,
  ``w_dq`` 2·d·rq, ``w_uq`` 2·rq·H·(n + e), ``w_dkv`` 2·d·r, ``w_kr``
  2·d·e, the absorption q_nope·W_uk 2·H·n·r, ``W_uv`` 2·H·r·v and ``wo``
  2·H·v·d; attention in the absorbed form, 2·H·(r + e) a key for the
  scores and 2·H·r a key for the weighted sum. The count is fixed by the
  configuration, not by the form the program runs.
- the channel of a layer below ``moe_start_layer``, or of any layer of a
  model without ``moe``: a gated MLP of ``d_ff``, 3·2·d·d_ff.
- ``moe`` (F = ``d_ff_expert``): the router 2·d·``router_experts``;
  ``n_shared`` shared SwiGLUs 3·2·d·F each; and ``top_k``·``n_experts``
  /``router_experts`` routed SwiGLUs 3·2·d·F each, the expected share of a
  token's ``top_k`` copies that land on the ``n_experts`` held on this
  chip. ``router_experts`` is the router's published width; left out, it
  is ``n_experts`` (every expert held here).
- the head: 2·d·``vocab_size`` a logit used.

The layers are laid out as the port's ``ModelConfig.block_specs`` lays
them: ``pattern`` tiled over ``n_layers``. A key the model leaves out
reads as the port's default (``pattern`` attn, ``moe_start_layer`` 0,
``mlp_act`` swiglu, ``n_shared`` 0, ``window`` none); every width is read
from the file. ``countable`` says whether these rules cover a model; for
one they do not (a ``ssm`` or ``rec`` mixer, an ungated MLP, an encoder,
a vision prefix, an audio front end or a ``blocks_override``) the counts
read None."""

__all__ = ["countable", "token_flops", "iteration_flops"]

MIXERS = ("attn", "attn_local", "mla")
UNCOUNTED = ("encoder", "vision", "audio", "blocks_override")


def countable(model: dict) -> bool:
    """Whether the rules above count every FLOP of ``model``'s step."""
    return (set(model.get("pattern", ["attn"])) <= set(MIXERS)
            and model.get("mlp_act", "swiglu") in ("swiglu", "geglu")
            and not any(k in model for k in UNCOUNTED))


def _exact(num: int, den: int):
    """num / den, an integer where it divides, so whole counts stay exact."""
    return num // den if num % den == 0 else num / den


def _table(model: dict):
    """(FLOPs a token through every layer's weights, {keys a layer
    attends at most (None: all): FLOPs a key over those layers}, FLOPs of
    a logit)."""
    d, pattern = model["d_model"], model.get("pattern", ["attn"])
    e = model.get("moe")
    fixed, per_key = 0, {}
    for li in range(model["n_layers"]):
        mixer = pattern[li % len(pattern)]
        if mixer == "mla":
            m = model["mla"]
            H, rq, r = m["n_heads"], m["q_lora_rank"], m["kv_lora_rank"]
            n, ro, v = m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"]
            fixed += 2 * (d * rq + rq * H * (n + ro) + d * r + d * ro
                          + H * n * r + H * r * v + H * v * d)
            window, key = None, 2 * H * (r + ro) + 2 * H * r
        else:
            a = model["attn"]
            H, KV, D = a["n_heads"], a["n_kv_heads"], a["head_dim"]
            fixed += 2 * d * (2 * H * D + 2 * KV * D)  # q, o, k, v
            window = a.get("window") if mixer == "attn_local" else None
            key = 4 * H * D  # scores and weighted sum
        per_key[window] = per_key.get(window, 0) + key
        if e is not None and li >= model.get("moe_start_layer", 0):
            F, R = e["d_ff_expert"], e.get("router_experts", e["n_experts"])
            fixed += 2 * d * R + e.get("n_shared", 0) * 3 * 2 * d * F
            fixed += _exact(e["top_k"] * e["n_experts"] * 3 * 2 * d * F, R)
        else:
            fixed += 3 * 2 * d * model["d_ff"]
    return fixed, per_key, 2 * d * model["vocab_size"]


def _keys(window, ctxs) -> int:
    """Keys attended by tokens at contexts ``ctxs`` in a layer that
    attends at most ``window`` keys."""
    return sum(ctxs) if window is None else sum(min(c, window) for c in ctxs)


def token_flops(model: dict, ctx: int, head: bool):
    """FLOPs of one token at context ``ctx`` (keys it attends to)."""
    if not countable(model):
        return None
    fixed, per_key, logit = _table(model)
    return fixed + sum(f * _keys(w, [ctx]) for w, f in per_key.items()) \
        + (logit if head else 0)


def iteration_flops(model: dict, decode_ctx, chunk):
    """decode_ctx: the context of each decode token the iteration served;
    chunk: (first position, real tokens) of its prefill chunk, or None."""
    if not countable(model):
        return None
    fixed, per_key, logit = _table(model)
    ctxs = list(decode_ctx)
    f = len(ctxs) * (fixed + logit)
    if chunk is not None:
        p0, n = chunk
        f += n * fixed + logit  # one logit: the chunk's last position
        ctxs += range(p0 + 1, p0 + n + 1)
    return f + sum(key * _keys(w, ctxs) for w, key in per_key.items())
