"""The benchmark's copied generators against the program's, and the rule
that every seed serves the same work in another order."""

from collections import Counter

import numpy as np
import pytest

from perfbench import traffic
from repro_torch.data.traces import ClassProfile, sample_lengths
from repro_torch.workloads.arrivals import MMPPArrivals, PoissonArrivals

SERVING = {"max_prompt": 6144, "max_output": 2048}


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 1])
def test_samplers_equal_the_programs(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(traffic.poisson_arrivals(a, 3.5, 40.0),
                                  PoissonArrivals(3.5).sample(b, 40.0))
    np.testing.assert_array_equal(
        traffic.mmpp_arrivals(a, 2.0, (0.55, 1.9), (1 / 4.5, 1 / 2.5), 60.0),
        MMPPArrivals(2.0, (0.55, 1.9), (1 / 4.5, 1 / 2.5)).sample(b, 60.0))
    prof = ClassProfile("code", 2048, 36, 1.2, 1.5)
    for _ in range(50):
        assert traffic.sample_lengths(a, 2048, 1.2, 36, 1.5) \
            == sample_lengths(b, prof)


@pytest.mark.parametrize("mix", ["azure_steady", "azure_overload"])
def test_seeds_share_the_work(mix):
    """The same arrival times and the same sizes under every seed, the
    sizes shuffled within blocks of ``shuffle_block`` arrivals; the seed
    draws the tokens."""
    m = traffic.load_mix(mix)
    runs = [traffic.generate(m, SERVING, 512, s, 20.0)
            for s in (1, 2, 2**33 + 9)]
    ref = runs[0]
    assert len(ref) > 20
    for rs in runs[1:]:
        assert [r.due for r in rs] == [r.due for r in ref]
        assert Counter((r.cls, r.prompt_len, r.decode_len) for r in rs) \
            == Counter((r.cls, r.prompt_len, r.decode_len) for r in ref)
        same_order = [r.prompt_len for r in rs] == [r.prompt_len for r in ref]
        assert same_order == (m["shuffle_block"] == 1)
        assert not np.array_equal(rs[0].prompt[:8], ref[0].prompt[:8])
    again = traffic.generate(m, SERVING, 512, 2, 20.0)
    assert all(np.array_equal(a.prompt, b.prompt)
               for a, b in zip(again, runs[1]))
    assert max(r.prompt_len for r in ref) <= SERVING["max_prompt"]
    assert max(r.decode_len for r in ref) <= SERVING["max_output"]


def test_mmpp_mix_keeps_its_time_average_rate():
    m = {"arrivals": {"process": "mmpp", "levels": [0.55, 1.9],
                      "switch": [1 / 4.5, 1 / 2.5]}, "rate": 6.0}
    t = traffic._arrivals(m, np.random.default_rng(3), 4000.0)
    assert abs(len(t) / 4000.0 - 6.0) < 0.3
