"""The design of the port's SSD chunk scan (B3), checked on the CPU.

* B3's bf16 route (``csrc/ssd_scan.cu``) runs its four products on tensor
  cores, bf16 in and f32 out, over chunks of 128 tokens: C B^T, W x with
  W = (C B^T) o L, the chunk's own state (x o seg)^T B, and the carried
  term C h.  C, B and x are bf16 and go in exactly; W, h and x o seg go
  in as three bf16 terms each.  ``_tc_emulation`` repeats that
  arithmetic in plain PyTorch, the state carry between chunks and the
  one-launch route of one chunk from a zero state included; it must hold
  ``ssd_scan_plain`` to ``chip_smoke.py``'s gates (y: SSD_Y_TOL bf16, the
  state: TOL float32).  Beside it, W rounded to bf16 once misses y's
  gate, as does h rounded once over several chunks, and x o seg rounded
  once misses the state's; with two terms (hi + lo), W and h leave y
  farther from float64 than the gate's absolute 1e-4, where three terms
  stay as close as the f32 plain version.  That is why the products are
  split in three.
* ``ssd_plan`` picks the split: every (b, chunk, head, p) lies in exactly
  one block, the scratch is what the three-launch route needs, the
  serving engine's chunk is one launch over enough blocks, and shared
  memory fits a block.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan.ops import ssd_plan, ssd_scan_plain

Y_GATE = (1e-4, 2.0 ** -7)  # chip_smoke.py SSD_Y_TOL["bfloat16"]
STATE_GATE = (3e-5, 3e-5)  # chip_smoke.py TOL["float32"]
CHUNK = 128  # csrc/ssd_scan.cu, tc::kQ
H100_SMS = 132
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on an H100


def _terms(v, n):
    """v (f32) as the sum of n bf16 roundings, each of what is left."""
    out = []
    for _ in range(n):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def _tc_emulation(x, Bm, Cm, log_a, initial_state=None, *, w_terms=3,
                  h_terms=3, xseg_terms=3):
    """The scan as B3's tensor-core route computes it.

    Products of bf16 terms are exact in f32, so each tensor-core product
    is an f32 einsum of the terms; only the summation order differs."""
    Bsz, S, H, P = x.shape
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    la = log_a.float()
    n_chunks = -(-S // CHUNK)
    one_chunk = n_chunks == 1 and initial_state is None
    h = (torch.zeros(Bsz, H, P, Bm.shape[-1]) if initial_state is None
         else initial_state.float())
    ys = []
    for c0 in range(0, S, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, S))
        q = sl.stop - c0
        cum = torch.cumsum(la[:, sl], dim=1)                      # (B,q,H)
        G = torch.einsum("btn,bsn->bts", Cf[:, sl], Bf[:, sl])    # once
        tri = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        W = torch.where(tri, G[..., None] * torch.exp(
            diff.masked_fill(~tri, 0.0)), torch.zeros(()))        # (B,t,s,H)
        y = sum(torch.einsum("btsh,bshp->bthp", w, xf[:, sl])
                for w in _terms(W, w_terms))
        if not one_chunk:  # the carried term, from the state entering
            inter = sum(torch.einsum("btn,bhpn->bthp", Cf[:, sl], t)
                        for t in _terms(h, h_terms))
            y = y + inter * torch.exp(cum)[..., None]
        ys.append(y.to(x.dtype))
        seg = torch.exp(cum[:, -1:] - cum)                        # (B,q,H)
        xseg = xf[:, sl] * seg[..., None]
        s_c = sum(torch.einsum("bshp,bsn->bhpn", t, Bf[:, sl])
                  for t in _terms(xseg, xseg_terms))
        h = s_c if one_chunk else \
            h * torch.exp(cum[:, -1])[:, :, None, None] + s_c
    return torch.cat(ys, dim=1), h


def _inputs(B, S, H, P, N, with_state=False, seed=0):
    """chip_smoke.py's recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    x = bf16(rng.standard_normal((B, S, H, P)))
    Bm = 0.5 * bf16(rng.standard_normal((B, S, N)))
    Cm = 0.5 * bf16(rng.standard_normal((B, S, N)))
    la = torch.from_numpy(
        (-0.1 * np.abs(rng.standard_normal((B, S, H)))).astype(np.float32))
    h0 = (torch.from_numpy(rng.standard_normal((B, H, P, N))
                           .astype(np.float32)) if with_state else None)
    return (x, Bm, Cm, la), h0


def _beyond(got, want, gate):
    atol, rtol = gate
    err = (got.float() - want.float()).abs()
    return int((err > atol + rtol * want.float().abs()).sum())


# the serving engine's chunk (mamba2-130m's heads), and multi-chunk shapes
# with a ragged last chunk, with and without an initial state
SHAPES = [(1, 16, 24, 64, 128, False), (1, 300, 4, 64, 128, False),
          (1, 300, 4, 64, 128, True), (2, 129, 3, 32, 64, True),
          (2, 1024, 24, 64, 128, True)]


@pytest.mark.parametrize("B,S,H,P,N,with_state", SHAPES)
def test_tc_arithmetic_holds_the_gates(B, S, H, P, N, with_state):
    args, h0 = _inputs(B, S, H, P, N, with_state)
    y, h = ssd_scan_plain(*args, initial_state=h0)
    ye, he = _tc_emulation(*args, initial_state=h0)
    assert ye.dtype == torch.bfloat16 and he.shape == h.shape
    assert _beyond(ye, y, Y_GATE) == 0
    assert _beyond(he, h, STATE_GATE) == 0


def test_w_rounded_once_misses_the_y_gate():
    """At the engine's chunk, one bf16 W puts over 1% of y past its gate."""
    args, _ = _inputs(1, 16, 24, 64, 128)
    y, _ = ssd_scan_plain(*args)
    ye, _ = _tc_emulation(*args, w_terms=1)
    assert _beyond(ye, y, Y_GATE) > 0.01 * y.numel()


def test_h_rounded_once_misses_the_y_gate():
    """Over several chunks, one bf16 carried state h in C h puts y past
    its gate (0.9% of it here)."""
    args, _ = _inputs(1, 512, 8, 64, 128)
    y, _ = ssd_scan_plain(*args)
    ye, _ = _tc_emulation(*args, h_terms=1)
    assert _beyond(ye, y, Y_GATE) > 0.001 * y.numel()


def test_two_terms_leave_y_past_the_gates_atol_from_float64():
    """hi + lo W and h: y up to 2.3e-4 from a float64 scan here, past the
    gate's absolute 1e-4 (an H100 run found one such output in 10^8 at
    B=8 S=8192); three terms: no farther than the f32 plain version."""
    args, _ = _inputs(1, 1024, 24, 64, 128, seed=5)
    y64, _ = ssd_scan_plain(*(a.double() for a in args))
    plain, _ = ssd_scan_plain(*(a.float() for a in args))
    x32 = args[0].float()  # y before its rounding to bf16

    def dist(y):
        return float((y.double() - y64).abs().max())

    two, _ = _tc_emulation(x32, *args[1:], w_terms=2, h_terms=2)
    three, _ = _tc_emulation(x32, *args[1:])
    assert dist(two) > Y_GATE[0]
    assert dist(three) <= dist(plain)


@pytest.mark.parametrize("S", [16, 300])
def test_xseg_rounded_once_misses_the_state_gate(S):
    """One bf16 x o seg puts most of the state past its f32 gate."""
    args, _ = _inputs(1, S, 4, 64, 128)
    _, h = ssd_scan_plain(*args)
    _, he = _tc_emulation(*args, xseg_terms=1)
    assert _beyond(he, h, STATE_GATE) > 0.5 * h.numel()


def _covered(plan, B, S, H, P):
    """How often each (b, chunk, head, p) falls in a block of the plan's
    grid, decoded as the kernel decodes blockIdx."""
    seen = np.zeros((B, plan.n_chunks, H, P), dtype=np.int64)
    n_ps = P // plan.pb
    n_blocks = 0
    for bx in range(-(-H // plan.hb) * n_ps):
        h0, p0 = (bx // n_ps) * plan.hb, (bx % n_ps) * plan.pb
        for c in range(plan.n_chunks):
            for b in range(B):
                seen[b, c, h0:min(H, h0 + plan.hb), p0:p0 + plan.pb] += 1
                n_blocks += 1
    return seen, n_blocks


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 16, 24, 64, 128), (4, 16, 24, 64, 128), (4, 2048, 24, 64, 128),
    (8, 8192, 24, 64, 128), (2, 300, 24, 64, 128), (1, 127, 2, 16, 16),
    (1, 128, 2, 16, 16), (1, 129, 2, 16, 16), (2, 256, 3, 16, 32),
    (1, 33, 2, 64, 256), (2, 100, 5, 256, 256), (3, 1000, 7, 48, 24)])
def test_ssd_plan_covers_the_scan_once(B, S, H, P, N, with_state):
    plan = ssd_plan(B, S, H, P, N, with_state, H100_SMS)
    assert plan.chunk == CHUNK and plan.n_chunks == -(-S // CHUNK)
    seen, n_blocks = _covered(plan, B, S, H, P)
    assert (seen == 1).all() and n_blocks == plan.blocks
    assert P % plan.pb == 0 and plan.pb % 16 == 0 and plan.pb <= 64
    assert 1 <= plan.hb <= H
    assert plan.smem <= SMEM_LIMIT
    if S <= CHUNK and not with_state:
        assert (plan.route, plan.kernels, plan.scratch_bytes) == \
            ("one-chunk", 1, 0)
    else:
        # f32 chunk states (B, chunks, H, P, N) and decays (B, chunks, H)
        rows = B * plan.n_chunks * H
        assert (plan.route, plan.kernels) == ("multi-chunk", 3)
        assert plan.scratch_bytes == 4 * rows * (P * N + 1)


def test_ssd_plan_at_the_serving_and_config_chunks():
    # the engine's chunk: one launch, spread over 96 blocks as before
    plan = ssd_plan(1, 16, 24, 64, 128, False, H100_SMS)
    assert (plan.route, plan.kernels, plan.blocks) == ("one-chunk", 1, 96)
    # the config's chunk: one wave, C B^T shared by 12 heads a block, and
    # 50 MB of chunk states (25 MB at Q = 256, 100 MB at Q = 64)
    plan = ssd_plan(4, 2048, 24, 64, 128, False, H100_SMS)
    assert (plan.hb, plan.pb, plan.blocks) == (12, 64, 128)
    assert 50e6 < plan.scratch_bytes < 51e6
