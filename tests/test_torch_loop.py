"""The slice as a whole: the calibrated control loop (calibrate -> fit ->
planning LP -> gate-and-route -> ClusterEngine replay) through the port
gives the reference's revenue rates bit for bit on the roofline backend,
and the port imports neither JAX nor the JAX package."""

import importlib
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (JAX and PyTorch share the process)
import pytest
import torch  # noqa: F401

import repro_torch

N_SERVERS = 10
HORIZON = 40.0
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)", re.M)


def _loop(pkg: str, grid: str, **cal_kw) -> dict:
    """bench_calibration's loop, replayed in the per-server engine."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    cal, tr, ty = mod("calibration"), mod("data.traces"), mod("core.types")
    pl, po, es = mod("core.planning"), mod("core.policies"), \
        mod("serving.engine_sim")
    art = cal.calibrate("qwen2-0.5b", grid=getattr(cal.CalibrationGrid,
                                                   grid)(), **cal_kw)
    trace = tr.synth_azure_trace(tr.TraceConfig(
        horizon=HORIZON, base_rate=2.0, compression=0.08, seed=42))
    classes = [ty.WorkloadClass(nm, m[0], m[1], m[2] / N_SERVERS,
                                patience=3e-4)
               for nm, m in zip(("code", "conv"),
                                tr.trace_class_means(trace, 2))]
    pricing = ty.Pricing(c_p=0.1, c_d=0.2)
    out = {"art": art}
    for label, model in (("seed", mod("calibration.models").AffineModel()),
                         ("fitted", cal.model_from_artifact(art, "fitted"))):
        prim = model.primitives()
        plan = pl.solve_bundled_lp(classes, prim, pricing,
                                   sli=pl.SLISpec(pin_zero_decode_queue=True))
        cfg = es.EngineConfig(prim=prim, pricing=pricing,
                              n_servers=N_SERVERS, iter_model=model)
        m = es.ClusterEngine(classes, po.gate_and_route(plan), cfg).run(
            trace, HORIZON)
        out[label] = m.summary()
    return out


@pytest.mark.parametrize("grid", ["tiny", "default"])
def test_roofline_loop_revenue_bitwise(grid):
    want = _loop("repro", grid, backend="roofline")
    got = _loop("repro_torch", grid, backend="roofline")
    assert got["art"].to_json() == want["art"].to_json()
    for label in ("seed", "fitted"):
        assert got[label] == pytest.approx(want[label], rel=0, abs=0,
                                           nan_ok=True)
        assert got[label]["revenue_rate"] == want[label]["revenue_rate"]
    if grid == "default":  # the numbers chip_smoke.py holds the card run to
        assert got["seed"]["revenue_rate"] == 2564.921648134311
        assert got["fitted"]["revenue_rate"] == 3087.8527206313215


def _fixed_cpu_timer(fn, *, warmup=2, reps=5):
    """Stands in for the host wall clock: runs ``fn`` once, so the plain
    versions still execute, and returns one fixed time.  A loaded host's
    outlier samples could turn the Huber fit's alpha negative, and then
    ``ServicePrimitives`` refuses the fitted model."""
    fn()
    return 1e-6


def test_kernels_loop_on_cpu_runs_through_plain_versions(monkeypatch):
    import repro_torch.calibration.measure as measure

    monkeypatch.setattr(measure, "timeit_median", _fixed_cpu_timer)
    got = _loop("repro_torch", "tiny", backend="kernels", device="cpu",
                reps=1, reduced=True)
    assert got["art"].backend == "kernels"
    assert got["art"].hw["device"] == "cpu"
    for label in ("seed", "fitted"):
        assert got[label]["revenue_rate"] > 0
        assert got[label]["completions"] > 0


def test_port_imports_neither_jax_nor_the_reference():
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    assert len(names) > 40
    # the dry-run and analysis tools are walked too
    assert {"repro_torch.configs.shapes", "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_analysis", "repro_torch.launch.roofline",
            "repro_torch.launch.perf_loop"} <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    # nor lazily, inside a function
    for path in Path(repro_torch.__path__[0]).rglob("*.py"):
        assert not IMPORT_RE.search(path.read_text()), path


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    code = (
        "import json, runpy, sys\n"
        f"runpy.run_path({str(script)!r}, run_name='not_main')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    # nor inside its functions, which run only on the card
    assert not IMPORT_RE.search(script.read_text())


def test_every_reference_module_has_a_twin():
    """Every ``.py`` of ``src/repro/`` has a file at the same relative
    path in ``src/repro_torch/``; a kernel's ``kernel.py`` (Pallas) and
    ``ref.py`` (its oracle) have theirs in ``ops.py`` (the wrapper and
    the plain version) and ``csrc/`` (the CUDA kernel)."""
    src = Path(__file__).resolve().parents[1] / "src"
    ref, port = src / "repro", src / "repro_torch"
    missing = []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref)
        if rel.parts[0] == "kernels" and rel.name in ("kernel.py", "ref.py"):
            assert (port / rel.parent / "ops.py").is_file(), rel
            assert any((port / "kernels" / "csrc").glob(
                f"{rel.parent.name}.cu")), rel
            continue
        if not (port / rel).is_file():
            missing.append(str(rel))
    assert missing == []
