"""A whole run on the CPU at the small size, with the look for a card
skipped: sound, it is correct; with the timed path broken underneath, it
is not; the control reads above the program; and the command itself
refuses a machine without a card and a process that holds JAX."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import check, harness
from perfbench.conftest import StepClock
from perfbench.reference import moe as ref_moe

ROOT = Path(__file__).resolve().parent.parent
BENCH = harness.load_bench(ROOT)
CELL = "grok1-2l.azure_steady"


def _run(cfg, mix, seed=2**33 + 5, **kw):
    return harness.run_cell(BENCH, CELL, seed=seed, seconds=1.5, trace=False,
                            device="cpu", cfg=cfg, mix=mix,
                            log=lambda s: None, clock=StepClock(), **kw)


def test_sound_run_is_correct(tiny_cell):
    res = _run(*tiny_cell())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 5
    assert set(res["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms",
                                   "revenue_per_s", "setup_s"}


def _stale(real):
    def make(cfg, *a, **k):
        step = real(cfg, *a, **k)

        def decode_step(params, state):
            step(params, state)
            return state, state["last_token"]
        return decode_step
    return make


def _half(real):
    def sample(logits):
        B = logits.shape[0]
        if B > 1:  # the decode batch: its second half left out
            logits = torch.cat([logits[:B // 2], logits[:B - B // 2]])
        return real(logits)
    return sample


def _altered(real):
    calls = [0]

    def sample(logits):
        calls[0] += 1
        tok = real(logits)
        return (tok + 1) % logits.shape[-1] if calls[0] % 4 == 0 else tok
    return sample


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    from repro_torch.serving import engine, steps

    if fault == "state_unchanged":
        stale = _stale(steps.make_decode_step)
        monkeypatch.setattr(steps, "make_decode_step", stale)
        monkeypatch.setattr(engine, "make_decode_step", stale)
    else:
        wrap = _half if fault == "half_batch" else _altered
        monkeypatch.setattr(steps, "greedy_sample",
                            wrap(steps.greedy_sample))
    res = _run(*tiny_cell())
    assert not res["correct"]
    got = res["checks"]["widest_gap_untied"]
    assert got["value"] > got["limit"]


def test_control_reads_above_the_program(tiny_cell):
    """The reference in fp8, put in the program's place, at the small
    size and in the served bf16: over the positions clear of a routing
    tie, its widest gap is three times the program's and over the
    limit, which the program's is under."""
    cfg, mix = tiny_cell("bfloat16")
    reads = []
    for seed in (1, 2):
        cell = harness.Cell(BENCH, CELL, seed, "cpu", cfg=cfg, mix=mix)
        classes, _, gate = cell.plan(mix["rate"])
        rec = cell.serve(cell.engine(), gate, len(classes), seed, 1.5,
                            mix["rate"], clock=StepClock())
        picked = check.sample(rec.requests, seed,
                              max_tokens=harness.SAMPLE_TOKENS,
                              min_served=harness.SAMPLE_SERVED)
        margins = []
        g, c = check.token_gaps(torch, ref_moe, cfg, cell.params, picked,
                                "cpu", control=True, margins=margins)
        keep = check.untied(margins, cfg["check"]["tie_margin"])
        reads.append((g[keep].max(), c[keep].max()))
    prog = max(p for p, _ in reads)
    ctrl = min(c for _, c in reads)
    limit = cfg["check"]["limits"]["widest_gap_untied"]
    assert ctrl > 3 * prog and prog < limit < ctrl, reads


def test_guard_compares_whole_top_level_names():
    mods = ["repro_torch.serving", "repro", "repro.core", "jax.numpy",
            "jaxlib", "jaxtyping", "flax", "flaxen", "reprox"]
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                               "repro", "repro.core"]


def test_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
