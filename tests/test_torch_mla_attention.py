"""B4, latent attention (``kernels/mla_attention``), on the CPU: its plain
version held to the JAX package's MLA, the kernel's two-pass arithmetic
emulated against the plain version, and the route ``models.mla`` takes.

The decode and the continuation chunk of reduced deepseek-v3-671b's MLA
layer run through ``models.mla`` (its plain route here) beside
``repro.models.mla`` on the same weights, latents and inputs, numpy
draws: ragged decode positions (1, 17, 48, the cache's last slot) and
chunks at an offset past 0 cut at ``kv_len`` below the cache's length,
whose slots past ``kv_len`` hold latents the reference masks by position.
f32: 1e-5 relative to the largest magnitude (summation order only).

The emulation runs the CUDA kernel's algorithm in PyTorch: per piece of
keys the scores' running max and base-2 sum, the pieces combined, p
formed with the row's final max and sum and rounded to bf16 before P.V,
the pieces' f32 partials summed and rounded.  It is held to the plain
version as ``tests/test_torch_gpu.py`` holds the kernel on the card
(``tests/mla_tolerance.py``): one bf16 rounding step of p where the two
f32 scores straddle a rounding point, and no more than 0.5% of outputs
past one rounding step (one pass that rounds the unnormalised p leaves
about 6% there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mla as RMLA
from repro_torch.configs import get_config
from repro_torch.kernels.mla_attention import ops
from repro_torch.models import mla as TMLA
from repro_torch.models.params import tree_map

from mla_tolerance import mla_close

CFG = get_config("deepseek-v3-671b", reduced=True).mla
REF_CFG = ref_get_config("deepseek-v3-671b", reduced=True).mla
D_MODEL, S = 64, 64
REL = 1e-5


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    defs = TMLA.mla_defs(CFG, D_MODEL)
    return {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])
                ).astype(np.float32) for k, d in defs.items()}


def _cache(B, seed=1):
    rng = np.random.default_rng(seed)
    return {"c_kv": rng.standard_normal((B, S, CFG.kv_lora_rank)
                                        ).astype(np.float32),
            "k_rope": rng.standard_normal((B, S, CFG.qk_rope_dim)
                                          ).astype(np.float32)}


def _both(p, cache):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in cache.items()},
            {k: jnp.asarray(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in cache.items()})


@pytest.mark.parametrize("positions", [[1, 17, 48, S - 1], [0, S - 1, 5, 30]])
def test_plain_decode_at_ragged_lengths_matches_the_reference(positions):
    p, cache = _weights(), _cache(4)
    tp, tc, rp, rc = _both(p, cache)
    x = np.random.default_rng(2).standard_normal((4, 1, D_MODEL)
                                                 ).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    got, gc = TMLA.mla_decode(CFG, tp, torch.from_numpy(x),
                              torch.from_numpy(pos), tc)
    want, wc = RMLA.mla_decode(REF_CFG, rp, jnp.asarray(x), jnp.asarray(pos),
                               rc)
    _close(got, want)
    for k in wc:
        _close(gc[k], wc[k])


@pytest.mark.parametrize("pos0,n,kv_len", [(0, 16, 16), (40, 16, 56),
                                           (23, 9, 40)])
def test_plain_chunk_cut_at_kv_len_matches_the_reference(pos0, n, kv_len):
    """A chunk of ``n`` queries from ``pos0`` given ``kv_len`` (at or past
    its end, below S): the slots past it hold latents the reference
    masks by position and the port does not read."""
    p, cache = _weights(3), _cache(1, 4)
    tp, tc, rp, rc = _both(p, cache)
    x = np.random.default_rng(5).standard_normal((1, n, D_MODEL)
                                                 ).astype(np.float32)
    pos = np.arange(pos0, pos0 + n, dtype=np.int32)[None]
    got, gc = TMLA.mla_prefill(CFG, tp, torch.from_numpy(x),
                               torch.from_numpy(pos), cache=tc,
                               continuation=True, kv_len=kv_len)
    want, wc = RMLA.mla_prefill(REF_CFG, rp, jnp.asarray(x), jnp.asarray(pos),
                                cache=rc, continuation=True)
    _close(got, want)
    for k in wc:
        _close(gc[k], wc[k])


def _emulate(q_lat, q_rope, c_kv, k_rope, positions, scale, kv_len, split):
    """The kernel's arithmetic: two passes over pieces of ``split`` keys,
    base-2 exponentials, p normalised before its rounding to bf16."""
    B, Sq, H, R = q_lat.shape
    c2 = scale * 1.4426950408889634
    kv = c_kv.shape[1] if kv_len is None else kv_len
    out = torch.empty(B, Sq, H, R)
    for b in range(B):
        for i in range(Sq):
            last = max(0, min(int(positions[b, i]), kv - 1))
            pieces = range(0, last + 1, split)
            s = [(q_lat[b, i].float() @ c_kv[b, k0:min(k0 + split, last + 1)]
                  .float().T + q_rope[b, i].float()
                  @ k_rope[b, k0:min(k0 + split, last + 1)].float().T)
                 for k0 in pieces]
            ms = [x.max(dim=1).values for x in s]
            ls = [torch.exp2((x - m[:, None]) * c2).sum(dim=1)
                  for x, m in zip(s, ms)]
            m = torch.stack(ms).max(dim=0).values
            lsum = sum(li * torch.exp2((mi - m) * c2)
                       for li, mi in zip(ls, ms))
            acc = torch.zeros(H, R)
            for k0, x in zip(pieces, s):
                pr = (torch.exp2(x * c2 - (m * c2)[:, None])
                      * (1.0 / lsum)[:, None]).to(torch.bfloat16).float()
                acc += pr @ c_kv[b, k0:k0 + x.shape[1]].float()
            out[b, i] = acc
    return out.to(torch.bfloat16)


def _rand(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


@pytest.mark.parametrize("split", [64, 256])
def test_two_pass_arithmetic_holds_the_plain_version(split):
    """The kernel's algorithm at the cell's widths (64 heads of 512 + 64),
    decode rows of 1, 17, 48 and 300 keys in pieces and a chunk of 8
    queries at an offset cut at ``kv_len``, held to the plain version as
    the card holds the kernel (``mla_tolerance.mla_close``)."""
    H, R, DR, SC = 64, 512, 64, 0.1352
    ql, qr = _rand((4, 1, H, R), 1), _rand((4, 1, H, DR), 2)
    ck, kr = _rand((4, 320, R), 3), _rand((4, 320, DR), 4)
    pos = torch.tensor([[0], [16], [47], [299]])
    mla_close(_emulate(ql, qr, ck, kr, pos, SC, None, split), ql, qr, ck, kr,
              pos, SC)
    ql, qr = _rand((1, 8, H, R), 5), _rand((1, 8, H, DR), 6)
    pos = torch.arange(200, 208)[None]
    mla_close(_emulate(ql, qr, ck[:1], kr[:1], pos, SC, 206, split), ql, qr,
              ck[:1], kr[:1], pos, SC, 206)


def test_split_plan():
    """The chunk's 512 queries run in one piece; a decode's 64 rows in
    pieces of 1024 keys; a short cache in one piece of whole tiles."""
    assert ops.mla_split(512, 128, 6144, 132) == (6144, 1)
    assert ops.mla_split(512, 128, 100, 132) == (128, 1)
    assert ops.mla_split(64, 128, 8192, 132) == (1024, 8)
    assert ops.mla_split(64, 128, 900, 132) == (960, 1)
    assert ops.mla_split(64, 128, 1025, 132) == (1024, 2)


def test_wrapper_checks_its_arguments():
    q, qr = _rand((1, 2, 64, 512), 0), _rand((1, 2, 64, 64), 1)
    c, r = _rand((1, 16, 512), 2), _rand((1, 16, 64), 3)
    pos = torch.tensor([[3, 4]])
    with pytest.raises(ValueError, match="positions"):
        ops.mla_attention(q, qr, c, r, pos[:, :1], scale=0.1)
    with pytest.raises(ValueError, match="kv_len"):
        ops.mla_attention(q, qr, c, r, pos, scale=0.1, kv_len=17)
    with pytest.raises(ValueError, match="c_kv"):
        ops.mla_attention(q, qr, c[..., :256].contiguous(), r, pos,
                          scale=0.1)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mla_attention(q.float().requires_grad_(), qr.float(), c.float(),
                          r.float(), pos, scale=0.1)


def _route_cases():
    """(name, call) pairs: each runs one MLA layer call on the CPU."""
    p = _weights(6)

    def layer(dtype, quant=False):
        tp = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
        cache = TMLA.init_mla_cache(CFG, 2, S, dtype, quant=quant,
                                    device="cpu")
        return tp, cache

    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 8, D_MODEL)).astype(np.float32))
    pos = torch.arange(8)[None].expand(2, 8)

    def decode(dtype, cache_dtype=None, quant=False):
        tp, cache = layer(cache_dtype or dtype, quant)
        tp = tree_map(lambda a: a.to(dtype), tp)
        return lambda: TMLA.mla_decode(CFG, tp, x[:, :1].to(dtype),
                                       torch.tensor([3, 9]), cache)

    def prefill(dtype, continuation, with_cache=True, quant=False):
        tp, cache = layer(dtype, quant)
        return lambda: TMLA.mla_prefill(
            CFG, tp, x.to(dtype), pos, cache=cache if with_cache else None,
            continuation=continuation, kv_len=12 if continuation else None)

    return {
        "bf16 decode": (decode(torch.bfloat16), 1),
        "bf16 chunk": (prefill(torch.bfloat16, True), 1),
        "f32 decode": (decode(torch.float32), 0),
        "f32 chunk": (prefill(torch.float32, True), 0),
        "bf16 over an f32 cache": (decode(torch.bfloat16, torch.float32), 0),
        "int8 decode": (decode(torch.bfloat16, quant=True), 0),
        "int8 chunk": (prefill(torch.bfloat16, True, quant=True), 0),
        "bf16 whole prompt": (prefill(torch.bfloat16, False), 0),
        "bf16 training (no cache)": (prefill(torch.bfloat16, False,
                                             with_cache=False), 0),
    }


@pytest.mark.parametrize("case", list(_route_cases()))
def test_route_is_b4_for_latents_in_the_queries_dtype(case, monkeypatch):
    """``models.mla`` hands the decode and the chunk over bf16 latents to
    B4's wrapper (which runs its plain version on the CPU and the kernel
    on the card); int8 latents, caches of another dtype, the whole prompt
    and training keep the plain path."""
    calls, plain = [], []
    b4, pl = TMLA.mla_attention, ops.mla_attention_plain

    def spy(*a, **kw):
        calls.append(a[0].dtype)
        return b4(*a, **kw)

    def spy_plain(*a, **kw):
        plain.append(a[0].device.type)
        return pl(*a, **kw)

    monkeypatch.setattr(TMLA, "mla_attention", spy)
    monkeypatch.setattr(ops, "mla_attention_plain", spy_plain)
    call, want = _route_cases()[case]
    call()
    assert calls == [torch.bfloat16] * want
    assert plain == ["cpu"] * want  # the wrapper's own CPU route
