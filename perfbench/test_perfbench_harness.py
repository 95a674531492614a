"""The harness loads every model the port's ``ModelConfig`` describes:
each of the port's configurations, written as a configuration file
writes it, loads back equal, and the weights of its reduced form have the
program's parameter tree."""

import pytest
import torch

from perfbench import harness
from perfbench.conftest import model_json
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.model import model_defs
from repro_torch.models.params import init_params

CASES = [(a, r) for a in ARCHS for r in (False, True)]


@pytest.mark.parametrize("arch,reduced", CASES, ids=[
    f"{a}-{'REDUCED' if r else 'CONFIG'}" for a, r in CASES])
def test_every_port_config_loads_equal(arch, reduced):
    want = get_config(arch, reduced)
    got = harness._model_config({"model": model_json(want)})
    assert got == want
    if reduced:
        params = init_params(model_defs(got),
                             torch.Generator().manual_seed(0), device="cpu")
        harness._check_layout(got, params)


@pytest.mark.parametrize("where", ["model", "mla", "moe"])
def test_an_unknown_key_raises(where):
    m = model_json(get_config("deepseek-v3-671b", reduced=True))
    (m if where == "model" else m[where])["no_such_key"] = 1
    with pytest.raises(ValueError, match="no_such_key"):
        harness._model_config({"model": m})
