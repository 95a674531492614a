"""``mla_roofline``'s reader on synthetic traced runs of the DeepSeek-V3
cell: B4's bound over its device time, counted by hand; None where a call
is missing from the trace, where the model has no MLA layer and where the
card is unknown."""

import numpy as np
import pytest

from perfbench import harness
from perfbench.driver import Iteration, Record
from perfbench.roofline import mla_attention as b4
from perfbench.roofline.peaks import PEAKS

CFG = harness.load_config("deepseek-v3-7l")
GROK = harness.load_config("grok1-2l")
PEAK = PEAKS["NVIDIA H100 80GB HBM3"]
LAYERS = CFG["model"]["n_layers"]  # all 7 are MLA layers


def _run(cfg=CFG, drop=0, peaks=PEAK):
    rec = Record(requests=[], open=1.0, close=3.0)
    lens = np.array([99, 0, 8191, 4])
    rec.iterations = [
        Iteration("mixed", 1.0, 1.05, [], (0, 512)),  # not traced
        Iteration("mixed", 1.05, 1.10, [], (1024, 300), lens),
        Iteration("solo", 1.10, 1.12, [], None, lens + 1),
    ]
    # microseconds: per layer and call the three kernels of B4, the
    # attend kernel 100 us, the others 1 us; 2 calls a layer in the mixed
    # iteration, 1 in the solo one
    kernels = [("void mla_gemm", 0.0, 5.0)]
    t = 10.0
    for _ in range(LAYERS * 3 - drop):
        for name, dt in (("void repro_torch::mla_stats_kernel(...)", 1.0),
                         ("void repro_torch::mla_attend_kernel(...)", 100.0),
                         ("void repro_torch::mla_combine_kernel(...)", 1.0)):
            kernels.append((name, t, t + dt))
            t += dt + 1.0
    ev = {"kernels": kernels, "ranges": [], "host": []}
    return harness.Run(rec, cfg, {}, ev, peaks)


def _read(run):
    return harness._reader("mla_roofline", harness.HERE)(run)


def test_mla_roofline_counts_the_bound_by_hand():
    H, r, e = 128, 512, 64
    per_key = H * (2 * (r + e) + 2 * r)  # 278 528
    lens = np.array([100, 1, 8192, 5])  # 8191 + 1 stays at 8192
    dec = b4.decode_work(lens, H, r, e, 2)
    assert dec == (2 * ((8298 + 4 * H) * 576 + 4 * H * 512) + 16,
                   8298 * per_key)
    keys = 300 * 1024 + 300 * 301 // 2
    chunk = b4.chunk_work(1024, 300, 1536, H, r, e, 2)
    assert chunk == (2 * ((1536 + 300 * H) * 576 + 300 * H * 512) + 1200,
                     keys * per_key)
    bound = (b4.bound_s(dec, PEAK) + b4.bound_s(chunk, PEAK)
             + b4.bound_s(b4.decode_work(np.minimum(lens + 1, 8192), H, r,
                                         e, 2), PEAK))
    busy = LAYERS * 3 * 102e-6
    got = _read(_run())
    assert got == pytest.approx(100 * LAYERS * bound / busy)
    assert 0 < got < 100


@pytest.mark.parametrize("case", ["a call missing", "no MLA layer",
                                  "unknown card"])
def test_mla_roofline_reads_nothing_where_nothing_is(case):
    run = {"a call missing": lambda: _run(drop=1),
           "no MLA layer": lambda: _run(cfg=GROK),
           "unknown card": lambda: _run(peaks=None)}[case]()
    assert _read(run) is None
