"""Plain float32 reference of the ``moe`` family (grok-1's block), and the
weights both sides are given.

A decoder-only LM with RMSNorm pre-norms, grouped-query attention with
rotary positions and an attention-logit softcap, and a top-k softmax
router over SwiGLU experts with capacity-based dispatch. Written from the
published equations (RoFormer, GQA, Switch/GShard capacity routing,
grok-1's softcap of 30 and embedding multiplier sqrt(d)); it imports
nothing of the program. Weights are drawn here from the seed, on the card,
in the served dtype, in the parameter tree the program takes.

``precision="fp8"`` is the correctness control: every matmul operand
(weights per output channel, activations per token, keys and values per
head) rounded to float8 e4m3 with its own scale, then computed in f32.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_params", "served_logits", "moe_reference"]

_QBLOCK = 1024  # query rows per attention block


def _cfg(cfg: dict):
    m = cfg["model"]
    a, e = m["attn"], m["moe"]
    return m, a, e


def make_params(cfg: dict, seed: int, device) -> dict:
    """The program's parameter tree, drawn from ``seed`` in the served
    dtype: one normal draw per leaf, scaled in place (std 1/sqrt(fan-in);
    embedding and router 0.02; norm scales 0.1 about RMSNorm's 1)."""
    m, a, e = _cfg(cfg)
    L, d, V = m["n_layers"], m["d_model"], m["vocab_size"]
    H, KV, D = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    E, F = e["n_experts"], e["d_ff_expert"]
    dt = getattr(torch, cfg["serving"]["weight_dtype"])
    g = torch.Generator(device=device).manual_seed(int(seed))

    def draw(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dt).mul_(std)

    return {
        "embed": draw((V, d), 0.02),
        "final_norm": {"scale": draw((d,), 0.1)},
        "unembed": draw((d, V), d ** -0.5),
        "seg0": {"b0": {
            "ln1": {"scale": draw((L, d), 0.1)},
            "attn": {"wq": draw((L, d, H, D), d ** -0.5),
                     "wk": draw((L, d, KV, D), d ** -0.5),
                     "wv": draw((L, d, KV, D), d ** -0.5),
                     "wo": draw((L, H, D, d), (H * D) ** -0.5)},
            "ln2": {"scale": draw((L, d), 0.1)},
            "moe": {"router": draw((L, d, E), 0.02),
                    "w_gate": draw((L, E, d, F), d ** -0.5),
                    "w_up": draw((L, E, d, F), d ** -0.5),
                    "w_down": draw((L, E, F, d), F ** -0.5)},
        }},
    }


def _fp8(x, dim):
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax over ``dim`` maps to 448), returned in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision}")
        self.fp8 = precision == "fp8"

    def w(self, w, contract_dim):
        w = w.float()
        return _fp8(w, contract_dim) if self.fp8 else w

    def act(self, x):
        return _fp8(x, -1) if self.fp8 else x


def _rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _rope(x, pos, theta):
    """Rotary embedding, rotate-half form: x (S, h, D), pos (S,)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = pos.float()[:, None] * inv[None, :]
    s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, softcap):
    """Causal GQA over one sequence: q (S,H,D), k/v (S,KV,D) -> (S,H,D)."""
    S, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    for s0 in range(0, S, _QBLOCK):
        s1 = min(S, s0 + _QBLOCK)
        sc = torch.einsum("qhd,khd->hqk", q[s0:s1], k[:s1]) / math.sqrt(D)
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        mask = torch.arange(s1, device=q.device)[None, :] \
            > torch.arange(s0, s1, device=q.device)[:, None]
        p = torch.softmax(sc.masked_fill(mask[None], float("-inf")), dim=-1)
        out[s0:s1] = torch.einsum("hqk,khd->qhd", p, v[:s1])
    return out


def moe_reference(x, p, li, e: dict, ops: _Ops, margins=None):
    """Top-k softmax routing with capacity dispatch over tokens x (T, d).

    Copies are ordered by expert, then by token (a stable sort), and an
    expert keeps the first ``ceil(T k / E * capacity_factor)`` of them,
    rounded up to a multiple of 8 and at least 8; the rest are dropped.
    Gate weights are renormalised over the k chosen experts. ``margins``,
    if a list, gets each token's router-logit margin between its k-th and
    (k+1)-th expert."""
    T = x.shape[0]
    E, k = e["n_experts"], e["top_k"]
    xa = ops.act(x)
    logits = xa @ ops.w(p["router"][li], 0)
    if margins is not None:  # how near each token's routing is to a tie
        top = torch.topk(logits, k + 1, dim=-1).values
        margins.append(top[:, k - 1] - top[:, k])
    probs = torch.softmax(logits, dim=-1)
    gw, idx = torch.topk(probs, k, dim=-1)
    if e.get("router_scale", True):
        gw = gw / gw.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = math.ceil(T * k / E * e["capacity_factor"])
    cap = max(8, -(-cap // 8) * 8)
    out = torch.zeros_like(x)
    for ex in range(E):
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)  # token order
        tok, slot = tok[:cap], slot[:cap]
        if tok.numel() == 0:
            continue
        xe = xa[tok]
        h = torch.nn.functional.silu(
            xe @ ops.w(p["w_gate"][li, ex], 0)) \
            * (xe @ ops.w(p["w_up"][li, ex], 0))
        y = ops.act(h) @ ops.w(p["w_down"][li, ex], 0)
        out.index_add_(0, tok, y * gw[tok, slot][:, None])
    return out


@torch.no_grad()
def served_logits(cfg: dict, params: dict, seqs, want, *,
                  precision: str = "f32", margins=None):
    """Logits (n_i, V) in f32 at positions ``want[i]`` of each token
    sequence ``seqs[i]`` (1-D int tensors on the weights' device), layer by
    layer over all sequences at once. ``margins``, if a list, gets one
    (all tokens,) tensor a layer: the router's margin (``moe_reference``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, a, e = _cfg(cfg)
    ops = _Ops(precision)
    H, KV, D = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    d = m["d_model"]
    b = params["seg0"]["b0"]
    lens = [int(s.shape[0]) for s in seqs]
    tok = torch.cat(list(seqs)).long()
    x = params["embed"][tok].float()
    if m.get("scale_embed"):
        x = x * math.sqrt(d)
    pos = torch.cat([torch.arange(n, device=x.device) for n in lens])
    for li in range(m["n_layers"]):
        pa = b["attn"]
        h = ops.act(_rmsnorm(x, b["ln1"]["scale"][li]))
        q = (h @ ops.w(pa["wq"][li].reshape(d, H * D), 0)).view(-1, H, D)
        kk = (h @ ops.w(pa["wk"][li].reshape(d, KV * D), 0)).view(-1, KV, D)
        vv = (h @ ops.w(pa["wv"][li].reshape(d, KV * D), 0)).view(-1, KV, D)
        q = _rope(q, pos, a["rope_theta"])
        kk = _rope(kk, pos, a["rope_theta"])
        if ops.fp8:
            kk, vv = _fp8(kk, -1), _fp8(vv, -1)
        o = torch.empty_like(q)
        s0 = 0
        for n in lens:
            o[s0:s0 + n] = _attention(q[s0:s0 + n], kk[s0:s0 + n],
                                      vv[s0:s0 + n], a.get("attn_softcap"))
            s0 += n
        x = x + ops.act(o.reshape(-1, H * D)) \
            @ ops.w(pa["wo"][li].reshape(H * D, d), 0)
        h = _rmsnorm(x, b["ln2"]["scale"][li])
        x = x + moe_reference(h, b["moe"], li, e, ops, margins)
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
