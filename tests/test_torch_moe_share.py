"""The MoE layer's expert-parallel share and its dispatch counter.

A layer told which experts it holds routes over all ``router_experts``
and computes its own experts' part: at R=16 the routed parts of four
shares (offsets 0, 4, 8, 12), with the shared expert counted once, add up
to the uncut layer.  At the defaults the layer dispatches the operations
it dispatched before the share existed.  The counter in
``repro_torch.telemetry.counters`` is fed only while ``torch.profiler``
runs."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.config import MoEConfig
from repro_torch.models.moe import _capacity, apply_moe, moe_defs
from repro_torch.models.params import init_params
from repro_torch.telemetry import counters

DS = dict(top_k=4, d_ff_expert=32, n_shared=1, router_experts=16,
          scoring="sigmoid", n_groups=4, topk_groups=2,
          routed_scale=2.5, capacity_factor=4.0)  # 16 / 4: nothing drops

# apply_moe's aten ops at the defaults (softmax top-2 over 4 experts, one
# shared expert), as the layer dispatched them before it held a share
GROK_OPS = (
    "view unsqueeze permute unsqueeze permute permute view permute view bmm "
    "view permute view _softmax topk sum clamp_min div view sort index "
    "floor_divide arange searchsorted arange index sub lt scalar_tensor "
    "where scalar_tensor where zeros index index_put_ slice unsqueeze "
    "permute unsqueeze permute permute view permute view bmm view permute "
    "view unsqueeze permute unsqueeze permute permute view permute view bmm "
    "view permute view silu mul unsqueeze permute unsqueeze permute permute "
    "view permute view bmm view permute view view index zeros index_put_ "
    "zeros index_put_ slice unsqueeze mul zeros slice view view index_add_ "
    "view view mm _unsafe_view view mm _unsafe_view silu mul view mm "
    "_unsafe_view add").split()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _uncut(seed, d=32):
    cfg = MoEConfig(n_experts=16, **DS)
    p = init_params(moe_defs(cfg, d), torch.Generator().manual_seed(seed),
                    device="cpu")
    p["router"].mul_((7168 / d) ** 0.5)  # its logits' spread at d = 7168
    x = torch.randn(2, 40, d, generator=torch.Generator().manual_seed(seed))
    return cfg, p, x


def _share(cfg, p, off, n=4):
    sub = {k: (v[off:off + n] if k in ("w_gate", "w_up", "w_down") else v)
           for k, v in p.items()}
    return MoEConfig(**dict(DS, n_experts=n, expert_offset=off)), sub


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_four_shares_and_the_shared_expert_add_up_to_the_uncut_layer(seed):
    cfg, p, x = _uncut(seed)
    whole = apply_moe(cfg, p, x)
    no_shared = {k: v for k, v in p.items() if k != "shared"}
    cfg0 = MoEConfig(**dict(DS, n_experts=16, n_shared=0))
    shared = whole - apply_moe(cfg0, no_shared, x)
    parts = [apply_moe(*_share(cfg, p, off), x) - shared
             for off in (0, 4, 8, 12)]
    torch.testing.assert_close(sum(parts) + shared, whole, atol=1e-5,
                               rtol=1e-5)
    # every share holds a part of the result
    assert all(q.abs().max() > 1e-3 for q in parts)


def test_a_share_sends_other_experts_copies_to_the_spare_row():
    """A share holds 4 of 16 experts: its capacity follows the router's
    width, and the copies routed elsewhere are computed by no expert."""
    cfg, p, x = _uncut(3)
    c4, p4 = _share(cfg, p, 8)
    assert _capacity(c4, 80) == _capacity(cfg, 80) == 80
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        counters.reset()
        apply_moe(c4, p4, x)
        tot = counters.moe_totals()
    counters.reset()
    assert tot["rows"] == 4 * 80 and tot["dropped"] == 0
    assert 0 < tot["kept"] < 80 * 4  # a share of the 320 copies


def test_defaults_dispatch_the_operations_they_dispatched_before():
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                    capacity_factor=2.0, n_shared=1)
    assert cfg.router_experts is None and cfg.scoring == "softmax"
    p = init_params(moe_defs(cfg, 16), torch.Generator().manual_seed(0),
                    device="cpu")
    assert sorted(p) == ["router", "shared", "w_down", "w_gate", "w_up"]
    assert p["router"].shape == (16, 4)
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(1))
    with _Ops() as rec:
        apply_moe(cfg, p, x)
    assert rec.ops == GROK_OPS


def test_the_counter_dispatches_nothing_while_the_profiler_is_off(
        monkeypatch):
    def never(*a, **k):
        raise AssertionError("counted without the profiler")

    monkeypatch.setattr(counters, "moe_dispatch", never)
    counters.reset()
    cfg, p, x = _uncut(4)
    with _Ops() as rec:
        apply_moe(cfg, p, x)
    with _Ops() as rec2:
        apply_moe(*_share(cfg, p, 4), x)
    assert counters.moe_totals() is None
    assert "stack" not in rec.ops and "stack" not in rec2.ops


@pytest.mark.parametrize("n,off,cf", [(16, 0, 4.0), (4, 4, 4.0),
                                      (16, 0, 1.0)])
def test_fill_is_the_copies_kept_over_experts_times_capacity(n, off, cf):
    """Kept copies over E x cap, counted by hand from the routing: all
    routed copies land here when every expert is held; at capacity
    factor 1 some past the capacity drop."""
    from repro_torch.models.moe import _route

    cfg, p, x = _uncut(5)
    cfg = MoEConfig(**dict(DS, n_experts=n, expert_offset=off,
                           capacity_factor=cf))
    sub = {k: (v[off:off + n] if k in ("w_gate", "w_up", "w_down") else v)
           for k, v in p.items()}
    T = x.shape[0] * x.shape[1]
    _, idx = _route(cfg, sub, x.reshape(T, -1))
    cap = _capacity(cfg, T)
    here = [int((idx == off + e).sum()) for e in range(n)]
    kept = sum(min(h, cap) for h in here)
    counters.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        apply_moe(cfg, sub, x)
    tot = counters.moe_totals()
    counters.reset()
    assert tot == {"calls": 1, "kept": kept, "dropped": sum(here) - kept,
                   "rows": n * cap}
    assert (tot["dropped"] > 0) == (cf < 4.0)
