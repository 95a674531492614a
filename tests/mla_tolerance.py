"""B4's tolerance (``kernels/mla_attention``): the kernel's output held to
its plain version, one definition for the card tests
(``test_torch_gpu.py``), the CPU emulation of the kernel's arithmetic
(``test_torch_mla_attention.py``) and ``chip_smoke.py``'s phase 3.

Both round p to bf16 after normalising it, each from its own f32 scores,
whose sums run in other orders: where the two values of p_k straddle a
bf16 rounding point they differ by one step, 2**-7 p_k at most, and the
output by up to 2**-7 p_k |v_k|.  So each output is held to
2**-7 (|want| + sum_k p_k |v_k|) + 1e-5.  Such straddles are rare, so at
most 0.5% of outputs may leave one rounding step of the output
(2**-7 |want| + 1e-5, the card tests' bf16 tolerance): two passes leave
about 0.05% there on random latents at the cell's widths, and one pass
that rounds the unnormalised p about 6%.
"""

import torch

from repro_torch.kernels.mla_attention.ops import mla_attention_plain

STEP = 2.0 ** -7  # one bf16 rounding step, relative
ATOL = 1e-5
PAST = 5e-3  # the share of outputs that may leave one rounding step


def mla_gap(got, q_lat, q_rope, c_kv, k_rope, positions, scale,
            kv_len=None) -> dict:
    """``got`` against the plain version on the same latents (with no NaN
    in them): ``finite``; ``within``, every |got - want| within its
    bound 2**-7 (|want| + sum p|v|) + 1e-5, and ``worst``, the largest
    over its bound; ``past``, the share of outputs past one rounding
    step of the output; ``max_abs_err``."""
    want = mla_attention_plain(q_lat, q_rope, c_kv, k_rope, positions,
                               scale=scale, kv_len=kv_len).float()
    if kv_len is not None:
        c_kv, k_rope = c_kv[:, :kv_len], k_rope[:, :kv_len]
    sc = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv.float())
          + torch.einsum("bqhk,bsk->bhqs", q_rope.float(), k_rope.float())) \
        * scale
    kpos = torch.arange(c_kv.shape[1], device=sc.device)
    p = torch.softmax(sc.masked_fill(kpos[None, None, None, :]
                                     > positions[:, None, :, None],
                                     float("-inf")), dim=-1)
    spread = torch.einsum("bhqs,bsr->bqhr", p, c_kv.float().abs())
    del sc, p
    got = got.float()
    d = (got - want).abs()
    bound = STEP * (want.abs() + spread) + ATOL
    return {"finite": bool(torch.isfinite(got).all()),
            "within": bool((d <= bound).all()),
            "worst": float((d / bound).max()),
            "past": float((d > STEP * want.abs() + ATOL).float().mean()),
            "max_abs_err": float(d.max())}


def mla_close(got, q_lat, q_rope, c_kv, k_rope, positions, scale,
              kv_len=None):
    """Asserts :func:`mla_gap`'s three limits."""
    gap = mla_gap(got, q_lat, q_rope, c_kv, k_rope, positions, scale,
                  kv_len)
    assert gap["finite"], gap
    assert gap["within"], gap
    assert gap["past"] <= PAST, gap
