"""Percentiles, censoring and window rates on a synthetic timeline."""

import numpy as np
import pytest

from perfbench import stats
from perfbench.driver import Iteration, Record
from perfbench.traffic import Request


def _req(rid, due, P, D, tokens, admitted=float("nan"), done=False):
    r = Request(rid, 0, due, np.zeros(P, np.int32), D)
    r.token_times = list(tokens)
    r.admitted = admitted
    r.done = done
    return r


@pytest.fixture
def rec():
    reqs = [
        _req(0, 0.5, 10, 2, [1.5, 1.6], admitted=1.0, done=True),  # before
        _req(1, 2.0, 100, 3, [2.5, 2.7, 3.0], admitted=2.1, done=True),
        _req(2, 3.0, 50, 4, [4.0, 4.5], admitted=3.5),
        _req(3, 5.0, 20, 2, [], admitted=5.5),  # no token by the close
        _req(4, 5.5, 20, 2, []),  # never admitted
        _req(5, 7.0, 20, 2, []),  # due after the close
    ]
    r = Record(requests=reqs, open=1.0, close=6.0)
    r.iterations = [Iteration("mixed", 1.0, 1.2, []),
                    Iteration("solo", 1.2, 1.3, []),
                    Iteration("mixed", 1.3, 1.6, []),
                    Iteration("mixed", 6.5, 7.0, [])]
    return r


def test_window_and_censoring(rec):
    assert [r.rid for r in stats.in_window(rec)] == [1, 2, 3, 4]
    assert stats.ttft(rec) == pytest.approx([0.5, 1.0, 1.0, 0.5])
    assert stats.queue_wait(rec) == pytest.approx([0.1, 0.5, 0.5, 0.5])


def test_gaps_count_when_the_later_token_is_in_the_window(rec):
    assert sorted(stats.tpot_gaps(rec)) == pytest.approx(
        sorted([0.1, 0.2, 0.3, 0.5]))


def test_revenue_counts_completions_inside_the_window(rec):
    # request 0 completes at 1.6 and request 1 at 3.0; 2 never completes
    want = (0.1 * 10 + 0.2 * 2 + 0.1 * 100 + 0.2 * 3) / 5.0
    assert stats.revenue_per_s(rec, 0.1, 0.2) == pytest.approx(want)


def test_p95_and_tau(rec):
    assert stats.p95(list(range(101))) == pytest.approx(95.0)
    assert stats.p95([]) is None
    assert stats.tau(rec, "mixed") == pytest.approx(0.25)
    assert stats.tau(rec, "mixed", skip=(0, 0)) == pytest.approx(0.3)
    assert stats.tau(rec, "solo") == pytest.approx(0.1)
