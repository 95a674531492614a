"""Every per-layer reader on a synthetic traced run: it loads by its
metric's name, reads what it should, and reads nothing where nothing is
there."""

import numpy as np
import pytest

from perfbench import harness
from perfbench.driver import Iteration, Record
from perfbench.roofline import decode_attention as b1
from perfbench.roofline.peaks import PEAKS
from perfbench.tracing import breakdown, busy_in, union
from perfbench.traffic import Request

BENCH = harness.load_bench(harness.HERE.parent)
CFG = harness.load_config("grok1-2l")
PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def _run(n_b1=4, peaks=PEAK):
    r = Request(0, 0, 1.1, np.zeros(100, np.int32), 3)
    r.admitted, r.token_times = 1.2, [1.5, 1.6, 1.7]
    rec = Record(requests=[r], open=1.0, close=3.0)
    lens = np.array([99, 0, 10, 0])
    rec.iterations = [
        Iteration("mixed", 1.0, 1.05, [], (0, 100)),
        Iteration("solo", 1.05, 1.07, [101], None, lens),
        Iteration("solo", 1.07, 1.09, [102], None, lens + 1),
        Iteration("mixed", 1.09, 1.14, [103], (0, 100)),
        Iteration("solo", 1.14, 1.17, [104]),
    ]
    rec.traced = (1, 2)
    # microseconds: two solo iterations, B1 once per layer in each
    ev = {"ranges": [("solo", 0.0, 100.0), ("solo", 100.0, 200.0)],
          "kernels": sorted([("gemm", 0.0, 50.0), ("gemm", 100.0, 140.0)]
                            + [("void decode_kernel<bf16>", 60.0 + 10 * i,
                                65.0 + 10 * i) for i in range(n_b1)],
                            key=lambda k: k[1]),
          "host": [("aten::mm", 40.0, 120.0)]}
    return harness.Run(rec, CFG, {}, ev, peaks)


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["per_layer"]])
def test_every_reader_loads_and_reads(m):
    v = harness._reader(m, harness.HERE)(_run())
    assert isinstance(v, float) and np.isfinite(v), (m, v)


def test_readers_read_the_right_numbers():
    run = _run()
    read = lambda m: harness._reader(m, harness.HERE)(run)  # noqa: E731
    assert read("tau_mix_ms") == pytest.approx(50.0)
    assert read("tau_solo_ms") == pytest.approx(30.0)  # the untraced one
    assert read("queue_wait_p95_ms") == pytest.approx(100.0)
    assert read("device_idle_in_step") == pytest.approx(100 * (1 - 110 / 200))
    a = CFG["model"]["attn"]
    bound = 2 * sum(b1.bound_s(np.minimum(x + 1, 8192), a["n_heads"],
                               a["n_kv_heads"], a["head_dim"], 2, PEAK)
                    for x in (np.array([99, 0, 10, 0]),
                              np.array([100, 1, 11, 1])))
    assert read("b1_roofline") == pytest.approx(100 * bound / 20e-6)


def test_readers_read_nothing_where_nothing_is():
    assert harness._reader("b1_roofline", harness.HERE)(_run(n_b1=3)) \
        is None  # a B1 call missing from the trace
    assert harness._reader("mfu", harness.HERE)(_run(peaks=None)) is None


def test_trace_arithmetic():
    assert union([(0, 2), (1, 3), (5, 6)]) == 4
    assert busy_in([(0, 2), (1, 3), (5, 6)], [(1, 5)]) == 3
    out = breakdown(_run().events)
    assert out["device_ops"][0] == ["gemm", pytest.approx(90e-6)]
    gaps = dict(out["idle_gaps"])
    assert gaps == {"aten::mm": pytest.approx(30e-6)}
