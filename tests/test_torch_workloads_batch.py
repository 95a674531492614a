"""The port's batched scenario generation (``repro_torch.workloads.batch``)
against the reference's, on the CPU.

The reference draws from JAX's threefry streams, the port from Philox, so
the two are held statistically: per scenario, the accepted counts, the
class shares and the mean prompt and decode lengths of the port's cells
agree with the reference's within two CI half-widths across 8 seeds,
and the counts match the intensity integral within 6 sigma.  Within the
port, fixed seeds give the same output and a ``ScenarioStream`` is
invariant to its chunk size (bitwise, the reference's metamorphic
property).
"""

import jax  # noqa: F401  (JAX and PyTorch share the process)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.workloads as rw
import repro.workloads.batch as rb
import repro_torch.workloads as tw
import repro_torch.workloads.batch as tb
from repro_torch.data.traces import validate_requests

NAMES = ("rate_shift", "flash_crowd", "azure_2023", "dolly_mix",
         "agentic_loops")
SEEDS = list(range(8))
H, SCALE = 90.0, 0.5


@pytest.fixture(scope="module")
def batches():
    port = tb.generate_batch([tw.get_scenario(n) for n in NAMES], SEEDS,
                             horizon=H, rate_scale=SCALE, device="cpu")
    ref = rb.generate_batch([rw.get_scenario(n) for n in NAMES], SEEDS,
                            horizon=H, rate_scale=SCALE)
    return port, ref


def _half_width(v):
    return 1.96 * np.std(v, ddof=1) / np.sqrt(len(v))


def _ci_close(a, b, label):
    a, b = np.asarray(a, float), np.asarray(b, float)
    tol = 2.0 * (_half_width(a) + _half_width(b)) + 1e-9
    assert abs(a.mean() - b.mean()) <= tol, (
        f"{label}: |{a.mean()} - {b.mean()}| > {tol}")


def test_batch_shapes_and_budget(batches):
    port, ref = batches
    S, K, R = port["t"].shape
    assert (S, K) == (len(NAMES), len(SEEDS))
    assert R == port["meta"]["R"] == ref["meta"]["R"]
    assert port["truncated"].sum() == 0  # candidate budget covered
    assert (port["n_real"] > 0).all()


def test_batch_cells_are_valid_traces(batches):
    port, _ = batches
    for s, name in enumerate(NAMES):
        scn = tw.get_scenario(name)
        for k in (0, 5):
            reqs = tb.batch_cell_requests(port, s, k)  # validates
            validate_requests(reqs)
            assert len(reqs) == int(port["n_real"][s, k])
            assert all(r.cls < scn.n_classes for r in reqs)
            tt = tb.batch_cell_tensors(port, s, k)
            assert tt.n_real == len(reqs)
            assert np.isinf(tt.t[~tt.valid]).all()
            assert (np.diff(tt.t[tt.valid]) >= 0).all()
            assert (tt.P >= 1).all() and (tt.D >= 1).all()


@pytest.mark.parametrize("name", NAMES)
def test_counts_shares_and_lengths_match_reference(batches, name):
    port, ref = batches
    s = NAMES.index(name)
    _ci_close(ref["n_real"][s], port["n_real"][s], f"{name} count")
    if name != "agentic_loops":  # MMPP: the regime path dominates
        proc = tw.get_scenario(name).arrivals.scaled(SCALE)
        h = min(H, tw.get_scenario(name).horizon)
        expect = proc.mean_rate(h) * h
        assert abs(port["n_real"][s].mean() - expect) < 6 * np.sqrt(expect)

    def per_seed(b, fn):
        return [fn(b, k) for k in range(len(SEEDS))]

    def share0(b, k):
        v = b["valid"][s, k]
        return (b["cls"][s, k][v] == 0).mean()

    _ci_close(per_seed(ref, share0), per_seed(port, share0),
              f"{name} class-0 share")
    for f in ("P", "D"):
        def mean_len(b, k, f=f):
            return b[f][s, k][b["valid"][s, k]].mean()

        _ci_close(per_seed(ref, mean_len), per_seed(port, mean_len),
                  f"{name} mean {f}")


def test_batch_patience_and_mix(batches):
    port, _ = batches
    s_dolly, s_azure = NAMES.index("dolly_mix"), NAMES.index("azure_2023")
    v = port["valid"][s_dolly, 0]
    assert np.isfinite(port["patience"][s_dolly, 0][v]).all()
    v = port["valid"][s_azure, 0]
    assert np.isinf(port["patience"][s_azure, 0][v]).all()
    s_rs = NAMES.index("rate_shift")
    t, cls, v = (port[k][s_rs, 0] for k in ("t", "cls", "valid"))
    early = cls[v & (t < 60.0)]
    assert early.size and early.mean() < 0.4


def test_batch_deterministic_and_seed_sensitive():
    scns = [tw.get_scenario("rate_shift"), tw.get_scenario("agentic_loops")]
    a = tb.generate_batch(scns, seeds=[7], horizon=40.0, device="cpu")
    b = tb.generate_batch(scns, seeds=[7], horizon=40.0, device="cpu")
    c = tb.generate_batch(scns, seeds=[8], horizon=40.0, device="cpu")
    for k in ("t", "cls", "P", "D", "valid", "n_real"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a["t"], c["t"])


def test_batch_rejects_empty():
    with pytest.raises(ValueError):
        tb.generate_batch([], seeds=[0], device="cpu")
    with pytest.raises(ValueError):
        tb.generate_batch([tw.get_scenario("rate_shift")], seeds=[],
                          device="cpu")


def _collect(name, seed, chunk):
    s = tb.ScenarioStream(tw.get_scenario(name), seed=seed,
                          chunk_size=chunk, horizon=40.0, device="cpu")
    rows = []
    while (ch := s.next_chunk()) is not None:
        rows.append(np.stack([ch.t[ch.valid], ch.cls[ch.valid],
                              ch.P[ch.valid], ch.D[ch.valid],
                              ch.patience[ch.valid]]))
    return np.concatenate(rows, axis=1)


@pytest.mark.parametrize("name", ["azure_2023", "agentic_loops",
                                  "dolly_mix"])
def test_scenario_stream_chunk_size_invariant(name):
    a, b = _collect(name, 4, 37), _collect(name, 4, 500)
    assert a.shape[1] > 0
    np.testing.assert_array_equal(a, b)


def test_scenario_stream_matches_reference_statistically():
    """Per-seed request counts and mean decode lengths of the port's
    stream within two CI half-widths of the reference's stream."""
    def stats(mod, w, seed):
        s = mod.ScenarioStream(w.get_scenario("azure_2023"), seed=seed,
                               chunk_size=512, horizon=120.0,
                               **({"device": "cpu"} if mod is tb else {}))
        n, dsum = 0, 0.0
        while (ch := s.next_chunk()) is not None:
            n += ch.n_real
            dsum += float(ch.D[ch.valid].sum())
        return n, dsum / max(n, 1)

    ref = [stats(rb, rw, s) for s in range(6)]
    port = [stats(tb, tw, s) for s in range(6)]
    _ci_close([r[0] for r in ref], [p[0] for p in port], "stream count")
    _ci_close([r[1] for r in ref], [p[1] for p in port], "stream mean D")
