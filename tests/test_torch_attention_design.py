"""The design choices of the port's attention kernels, checked on the CPU.

* B2's bf16 route (``csrc/prefill_attention.cu``) runs on tensor cores:
  bf16 Q/K/V, f32 scores over 64-key tiles, an online softmax in base 2,
  and P.V as two bf16 products, P_hi = bf16(P) and P_lo = bf16(P - P_hi).
  ``_tc_emulation`` repeats that arithmetic in plain PyTorch; it must hold
  ``prefill_attention_plain`` to ``chip_smoke.py``'s bf16 gate (one output
  rounding step, 1e-5 + 2**-7 |plain|).  Beside it, the same with P
  rounded to bf16 once misses that gate: that is why the kernel does two
  P.V products.
* B1 (``csrc/decode_attention.cu``) runs as one launch whose S-splits
  form a thread-block cluster; ``decode_plan`` picks the split.  Its
  blocks must cover every key once, clusters stay within 8 blocks, keys
  per block are whole warp tiles, and the grid fills the card's SMs at
  the calibration grid's shapes wherever S allows.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.calibration import CalibrationGrid
from repro_torch.kernels.decode_attention.ops import decode_plan
from repro_torch.kernels.prefill_attention.ops import prefill_attention_plain

GATE = (1e-5, 2.0 ** -7)  # chip_smoke.py TOL["bfloat16"]: atol, rtol
H100_SMS = 132


def _tc_emulation(q, k, v, *, split_p, bk=64):
    """Causal prefill as B2's tensor-core route computes it."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    log2e = 1.4426950408889634
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    o = torch.zeros(B, H, S, D)
    for k0 in range(0, S, bk):
        keys = torch.arange(k0, min(k0 + bk, S))
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf[:, keys]) \
            * (1.0 / math.sqrt(D))
        x = torch.where(keys[None, :] <= rows, sc * log2e, -math.inf)
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vf[:, keys])
        if split_p:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhqk,bkhd->bhqd", lo, vf[:, keys])
        o = o * alpha[..., None] + pv
        m = m_new
    return (o / l[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)


def _beyond_gate(got, want):
    atol, rtol = GATE
    err = (got.float() - want.float()).abs()
    return int((err > atol + rtol * want.float().abs()).sum())


@pytest.mark.parametrize("C", [128, 512])
@pytest.mark.parametrize("split_p", [True, False])
def test_tc_arithmetic_needs_p_as_two_bf16_products(C, split_p):
    """qwen2-0.5b's heads (H=14, KV=2, D=64), causal, at two calibration
    chunks: hi + lo P holds the gate everywhere; one bf16 P misses it on
    more than 1% of the outputs."""
    rng = np.random.default_rng(C)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16)
               for s in [(1, C, 14, 64), (1, C, 2, 64), (1, C, 2, 64)])
    want = prefill_attention_plain(q, k, v, causal=True)
    n_bad = _beyond_gate(_tc_emulation(q, k, v, split_p=split_p), want)
    if split_p:
        assert n_bad == 0
    else:
        assert n_bad > 0.01 * want.numel()


def _calibration_decode_shapes():
    """(B, per-stream cache length) of every cell's decode call."""
    return sorted({(c.batch, math.ceil(c.kv / c.batch))
                   for c in CalibrationGrid.default().cells()})


def _achievable(S, tile):
    """Cluster sizes (<= 8) that some whole-tile split of S gives."""
    return {math.ceil(S / L) for L in range(tile, S + tile, tile)
            if math.ceil(S / L) <= 8}


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("B,S", _calibration_decode_shapes()
                         + [(64, 4096), (3, 2000), (4, 300), (1, 1),
                            (2, 100000)])
def test_decode_plan_covers_keys_and_fills_the_card(B, S, elem_bytes):
    H, KV, D = 14, 2, 64  # qwen2-0.5b
    plan = decode_plan(B, S, H, KV, D, elem_bytes, H100_SMS)
    # every key in exactly one block, whole warp tiles per block
    assert plan.n_split * plan.split_len >= S
    assert (plan.n_split - 1) * plan.split_len < S
    assert 1 <= plan.n_split <= 8
    assert plan.split_len % plan.tile == 0 and plan.tile % plan.kw == 0
    assert plan.kw in (8, 16, 32)
    # the grid reaches the SM count where a whole-tile split can
    assert plan.rows == B * KV
    options = _achievable(S, plan.tile)
    target = math.ceil(H100_SMS / plan.rows)
    if any(n >= target for n in options):
        assert plan.blocks >= H100_SMS
    else:
        assert plan.n_split == max(options)
    assert plan.smem <= 232448


def test_decode_plan_at_the_card_tests_shapes():
    # the largest cluster (tests/test_torch_gpu.py runs this shape ragged)
    plan = decode_plan(3, 2000, 14, 2, 64, 2, H100_SMS)
    assert (plan.n_split, plan.split_len, plan.kw) == (8, 256, 32)
    # G = 10 heads: two passes of 8 head slots
    plan = decode_plan(2, 333, 20, 2, 64, 2, H100_SMS)
    assert (plan.gc, plan.n_pass, plan.rows) == (8, 2, 8)
    # short spans shrink the warp tile so all 4 warps take keys
    plan = decode_plan(16, 256, 14, 2, 64, 2, H100_SMS)
    assert plan.split_len == 32 and plan.kw == 8
    # wide heads: the ring holds fewer keys a warp
    for D, el, tile in ((128, 2, 16), (256, 2, 8), (256, 4, 4)):
        assert decode_plan(64, 4096, 8, 4, D, el, H100_SMS).tile == tile
