"""Fixtures of the benchmark's CPU tests: the cell's configuration and
mix cut to a size the CPU runs in seconds (the same keys, the same code
paths)."""

import copy
import dataclasses
import json

import pytest

from perfbench import harness, traffic


def tiny(dtype="float32"):
    cfg = copy.deepcopy(harness.load_config("grok1-2l"))
    m = cfg["model"]
    m.update(d_model=64, d_ff=128, vocab_size=512, max_seq_len=256,
             param_dtype=dtype)
    m["attn"].update(n_heads=4, n_kv_heads=2, head_dim=16)
    m["moe"].update(n_experts=4, d_ff_expert=64, capacity_factor=2.0)
    cfg["serving"].update(batch_cap=8, chunk=32, max_len=256, max_prompt=160,
                          max_output=64, weight_dtype=dtype,
                          cache_dtype=dtype)
    cfg["primitives"].update(alpha=0.01, beta=0.0, gamma=150.0)
    cfg["check"] = {"limits": {"widest_gap_untied": 1e-3 if dtype ==
                               "float32" else 0.2}, "tie_margin": 0.05}
    mix = copy.deepcopy(traffic.load_mix("azure_steady"))
    for c, p, d in zip(mix["classes"], (80, 40), (8, 20)):
        c["prompt"]["mean"], c["output"]["mean"] = p, d
    mix.update(rate=25.0, lead_s=0.3)
    return cfg, mix


def model_json(mcfg) -> dict:
    """The port's ``ModelConfig`` as a configuration file's ``model``
    block: through JSON, with the fields that are None left out."""
    def drop_none(x):
        if isinstance(x, dict):
            return {k: drop_none(v) for k, v in x.items() if v is not None}
        return x

    return json.loads(json.dumps(drop_none(dataclasses.asdict(mcfg))))


class StepClock:
    """A virtual wall clock: every reading advances it by ``tick`` seconds
    and ``sleep`` advances it at once, so a run on the CPU serves the same
    requests however fast the machine is."""

    def __init__(self, tick=0.004):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def sleep(self, dt):
        self.t += dt


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture(autouse=True)
def one_thread():
    """The small shapes run on one thread: on a loaded machine, threads
    spinning over tensors this small cost more than they give."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
