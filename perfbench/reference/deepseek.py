"""Plain float32 reference of the ``deepseek`` family (DeepSeek-V3's block),
and the weights both sides are given.

A decoder-only LM with RMSNorm pre-norms; multi-head latent attention
(MLA) in its plain, non-absorbed form: the query goes through a latent of
rank ``q_lora_rank`` and an RMSNorm, keys and values are expanded per head
from an RMSNormed KV latent of rank ``kv_lora_rank`` (k = [c_kv W_uk,
k_rope], v = c_kv W_uv), a rotary key shared by the heads, YaRN's rotary
frequencies and softmax scale; SwiGLU MLPs below ``moe_start_layer`` and
above it DeepSeek-V3's router over ``router_experts`` (sigmoid scores, a
selection bias, group-limited top-k, weights renormalised and scaled)
with the part of the held experts ``[expert_offset, expert_offset +
n_experts)`` and a shared expert. Written from the published equations
(DeepSeek-V3 technical report, arXiv:2412.19437, §2.1; the published
``inference/model.py``: ``Gate``, ``MLA``, ``precompute_freqs_cis``);
it imports nothing of the program. One departure, as in the program: the
rotary dims rotate as two halves, where the published code rotates
interleaved pairs (a fixed permutation of W_uq's and W_kr's rotary
columns, which random weights absorb). Weights are drawn here from the
seed, on the card, in the served dtype, in the parameter tree the program
takes.

``precision="fp8"`` is the correctness control: every matmul operand
(weights per output channel, activations per token, keys and values per
head) rounded to float8 e4m3 with its own scale, then computed in f32.
"""

from __future__ import annotations

import math

import torch

from .moe import _fp8, _Ops, _rmsnorm

__all__ = ["make_params", "served_logits", "route", "moe_reference",
           "rope_freqs"]

_QBLOCK = 512  # query rows per attention block


def _cfg(cfg: dict):
    m = cfg["model"]
    return m, m["mla"], m["moe"]


def _width(e: dict) -> int:
    return e.get("router_experts") or e["n_experts"]


def _segments(m: dict) -> list:
    """The program's tree of layers: from the left, the block of at most 4
    layer kinds (True: MoE) whose repeats cover the most layers, as
    [(kinds, repeats)]."""
    kinds = [li >= m.get("moe_start_layer", 0) for li in range(m["n_layers"])]
    segs, i = [], 0
    while i < len(kinds):
        best = (kinds[i:i + 1], 1)
        for p in range(1, min(4, len(kinds) - i) + 1):
            blk, r = kinds[i:i + p], 1
            while kinds[i + r * p:i + (r + 1) * p] == blk:
                r += 1
            if r * p > len(best[0]) * best[1]:
                best = (blk, r)
        segs.append(best)
        i += len(best[0]) * best[1]
    return segs


def _layers(m: dict) -> list:
    """Per layer, (segment key, block key, index in the stack, MoE)."""
    return [(f"seg{si}", f"b{bi}", r, moe)
            for si, (blk, rep) in enumerate(_segments(m))
            for r in range(rep) for bi, moe in enumerate(blk)]


def make_params(cfg: dict, seed: int, device) -> dict:
    """The program's parameter tree, drawn from ``seed`` in the served
    dtype: one normal draw per leaf, scaled in place (std 1/sqrt(fan-in);
    embedding and router 0.02; the router's selection bias 0.05; norm
    scales 0.1 about RMSNorm's 1)."""
    m, a, e = _cfg(cfg)
    d, V = m["d_model"], m["vocab_size"]
    H, rq, r = a["n_heads"], a["q_lora_rank"], a["kv_lora_rank"]
    n, ro, v = a["qk_nope_dim"], a["qk_rope_dim"], a["v_head_dim"]
    E, R, F = e["n_experts"], _width(e), e["d_ff_expert"]
    dt = getattr(torch, cfg["serving"]["weight_dtype"])
    g = torch.Generator(device=device).manual_seed(int(seed))

    def draw(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dt).mul_(std)

    def swiglu(lead, width):
        return {"w_gate": draw(lead + (d, width), d ** -0.5),
                "w_up": draw(lead + (d, width), d ** -0.5),
                "w_down": draw(lead + (width, d), width ** -0.5)}

    def block(k, moe):
        mla = {"w_dq": draw((k, d, rq), d ** -0.5),
               "w_uq": draw((k, rq, H, n + ro), rq ** -0.5),
               "w_dkv": draw((k, d, r), d ** -0.5),
               "w_kr": draw((k, d, ro), d ** -0.5),
               "w_uk": draw((k, r, H, n), r ** -0.5),
               "w_uv": draw((k, r, H, v), r ** -0.5),
               "wo": draw((k, H, v, d), (H * v) ** -0.5)}
        if a.get("latent_norms"):
            mla["q_norm"] = draw((k, rq), 0.1)
            mla["kv_norm"] = draw((k, r), 0.1)
        b = {"ln1": {"scale": draw((k, d), 0.1)}, "mla": mla,
             "ln2": {"scale": draw((k, d), 0.1)}}
        if not moe:
            b["mlp"] = swiglu((k,), m["d_ff"])
            return b
        b["moe"] = {"router": draw((k, d, R), 0.02)}
        if e.get("scoring") == "sigmoid":
            b["moe"]["router_bias"] = draw((k, R), 0.05)
        b["moe"].update(swiglu((k, E), F))
        if e.get("n_shared"):
            b["moe"]["shared"] = swiglu((k,), F * e["n_shared"])
        return b

    p = {"embed": draw((V, d), 0.02),
         "final_norm": {"scale": draw((d,), 0.1)},
         "unembed": draw((d, V), d ** -0.5)}
    for si, (blk, rep) in enumerate(_segments(m)):
        p[f"seg{si}"] = {f"b{bi}": block(rep, moe)
                         for bi, moe in enumerate(blk)}
    return p


def rope_freqs(dim: int, theta: float, yarn=None):
    """Rotary frequencies, f32; with ``yarn`` (the configuration's block)
    DeepSeek-V3's ``precompute_freqs_cis``: indices below
    floor(corr(beta_fast)) keep f, those above ceil(corr(beta_slow)) take
    f / factor, a linear ramp between, where corr(b) = dim ln(L0 / (2 pi
    b)) / (2 ln theta) and L0 the original context."""
    f = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    if yarn is None:
        return f

    def corr(b):
        return dim * math.log(yarn["original_max_len"] / (b * 2 * math.pi)) \
            / (2 * math.log(theta))

    lo = max(math.floor(corr(yarn["beta_fast"])), 0)
    hi = min(math.ceil(corr(yarn["beta_slow"])), dim - 1)
    if hi == lo:
        hi += 0.001
    smooth = 1 - ((torch.arange(dim // 2, dtype=torch.float32) - lo)
                  / (hi - lo)).clamp(0, 1)
    return f / yarn["factor"] * (1 - smooth) + f * smooth


def _rope(x, pos, freqs):
    """Rotary embedding, rotate-half form: x (S, h, D), pos (S,)."""
    D = x.shape[-1]
    ang = pos.float()[:, None] * freqs.to(x.device)[None, :]
    s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _softmax_scale(a: dict) -> float:
    scale = 1.0 / math.sqrt(a["qk_nope_dim"] + a["qk_rope_dim"])
    y = a.get("yarn")
    if y is not None and y["factor"] > 1:
        scale *= (0.1 * y["mscale_all_dim"] * math.log(y["factor"]) + 1) ** 2
    return scale


def _attention(q, k, v, scale):
    """Causal attention over one sequence: q, k (S,H,Dk), v (S,H,Dv)."""
    S = q.shape[0]
    out = q.new_empty((S, q.shape[1], v.shape[-1]))
    for s0 in range(0, S, _QBLOCK):
        s1 = min(S, s0 + _QBLOCK)
        sc = torch.einsum("qhd,khd->hqk", q[s0:s1], k[:s1]) * scale
        mask = torch.arange(s1, device=q.device)[None, :] \
            > torch.arange(s0, s1, device=q.device)[:, None]
        p = torch.softmax(sc.masked_fill(mask[None], float("-inf")), dim=-1)
        out[s0:s1] = torch.einsum("hqk,khd->qhd", p, v[:s1])
    return out


def mla_reference(h, p, li, a: dict, pos, lens, ops: _Ops):
    """Latent attention of normed tokens h (T, d) over sequences of
    ``lens`` (positions ``pos``), non-absorbed: per-head keys and values
    expanded from the normed KV latent."""
    H, rq, r = a["n_heads"], a["q_lora_rank"], a["kv_lora_rank"]
    n, ro, v = a["qk_nope_dim"], a["qk_rope_dim"], a["v_head_dim"]
    freqs = rope_freqs(ro, a["rope_theta"], a.get("yarn"))
    ha = ops.act(h)
    cq = ha @ ops.w(p["w_dq"][li], 0)
    ckv = ha @ ops.w(p["w_dkv"][li], 0)
    if a.get("latent_norms"):
        cq = _rmsnorm(cq, p["q_norm"][li])
        ckv = _rmsnorm(ckv, p["kv_norm"][li])
    q = (ops.act(cq) @ ops.w(p["w_uq"][li].reshape(rq, H * (n + ro)), 0)) \
        .view(-1, H, n + ro)
    q = torch.cat([q[..., :n], _rope(q[..., n:], pos, freqs)], dim=-1)
    k_rope = _rope((ha @ ops.w(p["w_kr"][li], 0))[:, None, :], pos, freqs)
    ca = ops.act(ckv)
    k = (ca @ ops.w(p["w_uk"][li].reshape(r, H * n), 0)).view(-1, H, n)
    k = torch.cat([k, k_rope.expand(-1, H, -1)], dim=-1)
    vv = (ca @ ops.w(p["w_uv"][li].reshape(r, H * v), 0)).view(-1, H, v)
    if ops.fp8:
        k, vv = _fp8(k, -1), _fp8(vv, -1)
    o = q.new_empty((q.shape[0], H, v))
    s0, scale = 0, _softmax_scale(a)
    for S in lens:
        o[s0:s0 + S] = _attention(q[s0:s0 + S], k[s0:s0 + S],
                                  vv[s0:s0 + S], scale)
        s0 += S
    return ops.act(o.reshape(-1, H * v)) \
        @ ops.w(p["wo"][li].reshape(H * v, -1), 0)


def route(x, p, li, e: dict, ops: _Ops, margins=None):
    """DeepSeek-V3's gate over tokens x (T, d): (weights (T, k), expert
    ids (T, k) over ``router_experts``). s = sigmoid(x W) in f32; the
    selection scores add ``router_bias``; a group's score is the sum of its
    two best selection scores, the ``topk_groups`` best groups stay, and
    the k best selection scores among them choose; the weights are the
    chosen unbiased s over their sum, times ``routed_scale``.
    ``margins``, if a list, gets each token's margin to a tie, in router
    logits: the lesser of the cut between the k-th and (k+1)-th selection
    scores among the kept groups, and of the cut between the last kept
    group and the best left out, each the gap of the two scores over the
    mean of their slopes in the logits (s (1 - s) for an expert, the sum
    over its two best for a group): to first order, how far apart the
    logits lie at the cut, as a softmax router's margin is read."""
    T, R, k = x.shape[0], _width(e), e["top_k"]
    G, TG = e.get("n_groups", 1), e.get("topk_groups", 1)
    s = torch.sigmoid(ops.act(x) @ ops.w(p["router"][li], 0))
    slope = s * (1 - s)
    sel = s + p["router_bias"][li].float()
    gm = torch.full((T,), float("inf"), device=x.device)
    if G > 1:
        best, at = sel.view(T, G, R // G).topk(2, dim=-1)
        gs = best.sum(-1)
        gsl = slope.view(T, G, R // G).gather(2, at).sum(-1)
        top, kept = gs.topk(min(TG + 1, G), dim=-1)
        if TG < G:
            gm = 2 * (top[:, TG - 1] - top[:, TG]) \
                / gsl.gather(1, kept[:, TG - 1:TG + 1]).sum(-1)
        keep = torch.zeros((T, G), dtype=torch.bool, device=x.device)
        keep.scatter_(1, kept[:, :TG], True)
        sel = sel.view(T, G, R // G).masked_fill(~keep[..., None],
                                                 float("-inf")).flatten(1)
    vals, idx = sel.topk(k + 1, dim=-1)
    if margins is not None:
        em = 2 * (vals[:, k - 1] - vals[:, k]) \
            / slope.gather(1, idx[:, k - 1:k + 1]).sum(-1)
        margins.append(torch.minimum(em, gm))
    idx = idx[:, :k]
    w = s.gather(1, idx)
    if e.get("router_scale", True):
        w = w / w.sum(-1, keepdim=True)
    return w * e.get("routed_scale", 1.0), idx


def moe_reference(x, p, li, e: dict, ops: _Ops, margins=None):
    """The held experts' part of the routed output over tokens x (T, d),
    plus the shared experts.

    An expert keeps its first ``ceil(T k / router_experts *
    capacity_factor)`` copies in token order, rounded up to a multiple of
    8 and at least 8; copies to experts not held here add nothing."""
    T, E, k = x.shape[0], e["n_experts"], e["top_k"]
    off = e.get("expert_offset", 0)
    gw, idx = route(x, p, li, e, ops, margins)
    cap = math.ceil(T * k / _width(e) * e["capacity_factor"])
    cap = max(8, -(-cap // 8) * 8)
    xa = ops.act(x)
    out = torch.zeros_like(x)

    def swiglu(xe, w):
        h = torch.nn.functional.silu(xe @ ops.w(w["w_gate"], 0)) \
            * (xe @ ops.w(w["w_up"], 0))
        return ops.act(h) @ ops.w(w["w_down"], 0)

    for ex in range(E):
        tok, slot = torch.nonzero(idx == off + ex, as_tuple=True)
        tok, slot = tok[:cap], slot[:cap]
        if tok.numel():
            y = swiglu(xa[tok], {n: p[n][li, ex]
                                 for n in ("w_gate", "w_up", "w_down")})
            out.index_add_(0, tok, y * gw[tok, slot][:, None])
    if "shared" in p:
        out = out + swiglu(xa, {n: w[li] for n, w in p["shared"].items()})
    return out


@torch.no_grad()
def served_logits(cfg: dict, params: dict, seqs, want, *,
                  precision: str = "f32", margins=None):
    """Logits (n_i, V) in f32 at positions ``want[i]`` of each token
    sequence ``seqs[i]`` (1-D int tensors on the weights' device), layer by
    layer over all sequences at once. ``margins``, if a list, gets one
    (all tokens,) tensor a MoE layer: the router's margin (``route``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, a, e = _cfg(cfg)
    ops = _Ops(precision)
    lens = [int(s.shape[0]) for s in seqs]
    x = params["embed"][torch.cat(list(seqs)).long()].float()
    pos = torch.cat([torch.arange(n, device=x.device) for n in lens])
    for seg, blk, j, moe in _layers(m):
        b = params[seg][blk]
        h = _rmsnorm(x, b["ln1"]["scale"][j])
        x = x + mla_reference(h, b["mla"], j, a, pos, lens, ops)
        h = _rmsnorm(x, b["ln2"]["scale"][j])
        if moe:
            x = x + moe_reference(h, b["moe"], j, e, ops, margins)
        else:
            w = {n: t[j] for n, t in b["mlp"].items()}
            ha = ops.act(h)
            y = torch.nn.functional.silu(ha @ ops.w(w["w_gate"], 0)) \
                * (ha @ ops.w(w["w_up"], 0))
            x = x + ops.act(y) @ ops.w(w["w_down"], 0)
    starts = [sum(lens[:i]) for i in range(len(lens))]
    rows = torch.cat([torch.as_tensor(w, device=x.device) + s0
                      for w, s0 in zip(want, starts)])
    hx = ops.act(_rmsnorm(x[rows], params["final_norm"]["scale"]))
    logits = hx @ ops.w(params["unembed"], 0)
    out, r0 = [], 0
    for w in want:
        out.append(logits[r0:r0 + len(w)])
        r0 += len(w)
    return out
