"""Each plain reference against the program on the CPU, at the cell's
configuration cut to a small size."""

import numpy as np
import pytest
import torch

from perfbench import harness, traffic
from perfbench.reference import gate as ref_gate
from perfbench.reference import moe as ref_moe


def test_weights_have_the_programs_tree(tiny_cell):
    cfg, _ = tiny_cell()
    harness._check_layout(harness._model_config(cfg),
                          ref_moe.make_params(cfg, 5, "cpu"))


def test_served_logits_equal_the_programs_forward(tiny_cell):
    from repro_torch.models import model as M

    cfg, _ = tiny_cell()
    params = ref_moe.make_params(cfg, 11, "cpu")
    mcfg = harness._model_config(cfg)
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, 512, (n,), generator=g) for n in (37, 90)]
    want = [np.arange(n) for n in (37, 90)]
    ref = ref_moe.served_logits(cfg, params, seqs, want)
    for s, r in zip(seqs, ref):
        got, _ = M.forward_train(mcfg, params, s[None])
        torch.testing.assert_close(got[0].float(), r, atol=2e-4, rtol=1e-4)


def test_moe_reference_drops_the_copies_the_program_drops(tiny_cell):
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import apply_moe

    cfg, _ = tiny_cell()
    e = dict(cfg["model"]["moe"], capacity_factor=0.5)
    p = ref_moe.make_params(cfg, 3, "cpu")["seg0"]["b0"]["moe"]
    x = torch.randn(1, 96, 64, generator=torch.Generator().manual_seed(1))
    got = apply_moe(MoEConfig(**e), {k: v[1] for k, v in p.items()}, x)[0]
    ref = ref_moe.moe_reference(x[0], p, 1, e, ref_moe._Ops("f32"))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    # the rule bites: a dropless capacity gives another answer
    full = ref_moe.moe_reference(x[0], p, 1, dict(e, capacity_factor=4.0),
                                 ref_moe._Ops("f32"))
    assert (full - ref).abs().max() > 1e-3


@pytest.mark.parametrize("mix,rate", [("azure_steady", 4.0),
                                      ("azure_overload", 9.0)])
def test_reference_plan_and_gate_equal_the_programs(mix, rate):
    from repro_torch.core.planning import solve_bundled_lp
    from repro_torch.core.policies import OccupancyGate
    from repro_torch.core.types import Pricing, ServicePrimitives

    cfg = harness.load_config("grok1-2l")
    m = dict(traffic.load_mix(mix), rate=rate)
    pr, sv = cfg["primitives"], cfg["serving"]
    prim = ServicePrimitives(pr["alpha"], pr["beta"], pr["gamma"],
                             sv["batch_cap"], sv["chunk"])
    classes = harness._classes(cfg, m)
    plan = solve_bundled_lp(classes, prim, Pricing(**m["pricing"]))
    x, qp, R = ref_gate.solve_plan(
        [(c.prompt_len, c.decode_len, c.arrival_rate, c.patience)
         for c in classes], dict(pr, batch_cap=sv["batch_cap"],
                                 chunk=sv["chunk"]), 0.1, 0.2)
    assert R == pytest.approx(plan.revenue_rate, rel=1e-6)
    np.testing.assert_allclose(x, plan.x, rtol=1e-6, atol=1e-9)
    gate = OccupancyGate(plan.x, plan.qp)
    rng = np.random.default_rng(4)

    class View:
        def __init__(self, q, X):
            self.q, self.X = q, X

        def prefill_queue_len(self, i):
            return self.q[i]

        def prefill_in_service(self, i):
            return self.X[i]

        def n_servers(self):
            return 1

    for _ in range(200):
        q = rng.integers(0, 5, 2)
        X = rng.integers(0, 2, 2)
        waiting = [i for i in range(2) if q[i]]
        if waiting:
            assert ref_gate.gate_choice(x, qp, waiting, q, X) \
                == gate.select(View(q, X), waiting)
