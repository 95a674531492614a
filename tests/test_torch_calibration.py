"""The port's calibration stack held to the JAX package: parameter
counts and shape trees, the roofline backend bit for bit, the fitter,
the artifact schema, and the kernels backend's control flow on the CPU."""

import dataclasses
import json
import subprocess
import sys

import jax  # noqa: F401  (JAX and PyTorch share the process)
import pytest
import torch

from repro import calibration as ref_cal
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.core.planning import SLISpec as RefSLISpec
from repro.core.planning import solve_bundled_lp as ref_solve
from repro.core.types import Pricing as RefPricing
from repro.core.types import WorkloadClass as RefWorkloadClass
from repro.launch.mesh import v5e_constants as ref_v5e
from repro.models.model import active_param_count as ref_active
from repro.models.model import model_defs as ref_model_defs
from repro.models.params import _walk as ref_walk
from repro_torch import calibration as cal
from repro_torch.calibration.fit import fit_surfaces
from repro_torch.calibration.measure import Sample
from repro_torch.compat import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.planning import SLISpec, solve_bundled_lp
from repro_torch.core.types import Pricing, WorkloadClass
from repro_torch.launch import mesh
from repro_torch.models.model import (active_param_count, model_defs,
                                      param_count)
from repro_torch.models.params import _walk

ALL_ARCHS = sorted(ARCHS)


def test_arch_registry_matches_reference():
    assert ARCHS == REF_ARCHS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert active_param_count(cfg) == ref_active(ref_cfg)
    if arch == "qwen2-0.5b":
        assert active_param_count(cfg) == 494_032_768


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_model_defs_paths_and_shapes_match_reference(arch, reduced):
    got = [(p, d.shape, d.axes, d.init, d.scale)
           for p, d in _walk(model_defs(get_config(arch, reduced)))]
    want = [(p, d.shape, d.axes, d.init, d.scale)
            for p, d in ref_walk(ref_model_defs(ref_get_config(arch, reduced)))]
    assert got == want
    assert param_count(get_config(arch, reduced)) == sum(
        int(torch.tensor(s).prod()) for _, s, *_ in want)


def test_v5e_table_is_the_reference_table():
    assert mesh.v5e_constants() == ref_v5e()


def test_gpu_tables():
    part, consts = mesh.gpu_table("NVIDIA H100 80GB HBM3")
    assert part == "H100 SXM"
    assert consts == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                      "link_bw": 25e9}
    assert mesh.gpu_table("NVIDIA H100 PCIe")[1] == {
        "peak_flops_bf16": 756e12, "hbm_bw": 2.0e12}
    with pytest.raises(KeyError, match="NVIDIA A100-SXM4-40GB"):
        mesh.gpu_table("NVIDIA A100-SXM4-40GB")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("grid", ["tiny", "default"])
def test_roofline_calibration_bitwise(arch, grid):
    want = ref_cal.calibrate(arch, backend="roofline",
                             grid=getattr(ref_cal.CalibrationGrid, grid)())
    got = cal.calibrate(arch, backend="roofline",
                        grid=getattr(cal.CalibrationGrid, grid)())
    assert got.to_json() == want.to_json()
    assert (got.alpha, got.beta, got.a_s, got.b_s) == \
        (want.alpha, want.beta, want.a_s, want.b_s)


def test_auto_backend_without_a_card_is_roofline():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: auto means kernels there")
    assert cal.calibrate("qwen2-0.5b", grid=cal.CalibrationGrid.tiny()
                         ).backend == "roofline"


def test_reference_artifact_loads_with_equal_primitives_and_plans(tmp_path):
    ref_art = ref_cal.calibrate("qwen2-0.5b", backend="roofline")
    path = ref_art.save(tmp_path / "ref.json")
    art = cal.CalibrationArtifact.load(path)
    assert art.to_json() == ref_art.to_json()
    assert dataclasses.astuple(art.primitives()) == \
        dataclasses.astuple(ref_art.primitives())
    for kind in ("fitted", "table"):
        m, rm = (cal.model_from_artifact(art, kind),
                 ref_cal.model_from_artifact(ref_art, kind))
        assert dataclasses.astuple(m.primitives()) == \
            dataclasses.astuple(rm.primitives())
        assert [m.tau_mix(c) for c in (0, 17, 300, 900)] == \
            [rm.tau_mix(c) for c in (0, 17, 300, 900)]
        assert [m.tau_solo(k) for k in (0, 500, 9000)] == \
            [rm.tau_solo(k) for k in (0, 500, 9000)]
    classes = [WorkloadClass("a", 300, 1000, 0.5, 0.1),
               WorkloadClass("b", 3000, 400, 0.5, 0.1)]
    ref_classes = [RefWorkloadClass("a", 300, 1000, 0.5, 0.1),
                   RefWorkloadClass("b", 3000, 400, 0.5, 0.1)]
    plan = solve_bundled_lp(classes, art.primitives(), Pricing(0.1, 0.2),
                            sli=SLISpec(pin_zero_decode_queue=True))
    ref_plan = ref_solve(ref_classes, ref_art.primitives(),
                         RefPricing(0.1, 0.2),
                         sli=RefSLISpec(pin_zero_decode_queue=True))
    assert plan.revenue_rate == ref_plan.revenue_rate
    assert plan.x.tolist() == ref_plan.x.tolist()


def test_kernels_backend_on_cpu_writes_a_marked_valid_artifact(tmp_path):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    launches = (decode_attention.launches, prefill_attention.launches)
    art = cal.calibrate("qwen2-0.5b", backend="kernels", reps=1,
                        grid=cal.CalibrationGrid.tiny(), device="cpu")
    assert art.backend == "kernels" and art.hw["device"] == "cpu"
    assert all(s.backend == "kernels" and s.tau > 0 for s in art.samples)
    assert len(art.samples) == cal.CalibrationGrid.tiny().n_cells
    # the plain versions ran: no kernel launch is counted on the CPU
    assert (decode_attention.launches, prefill_attention.launches) == launches
    back = cal.CalibrationArtifact.load(art.save(tmp_path / "cpu.json"))
    assert back == art
    d = json.loads((tmp_path / "cpu.json").read_text())
    assert d["schema_version"] == cal.SCHEMA_VERSION
    assert d["hw"]["table"] == "H100 SXM"


def test_cli_roofline_artifact_matches_reference(tmp_path):
    out = tmp_path / "cli.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.calibration", "--backend",
         "roofline", "--tiny", "--out", str(out)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "backend=roofline" in proc.stdout
    want = ref_cal.calibrate("qwen2-0.5b", backend="roofline",
                             grid=ref_cal.CalibrationGrid.tiny())
    assert cal.CalibrationArtifact.load(out).to_json() == want.to_json()


# The recorded Hypothesis example of the reference's
# test_fitter_survives_one_outlier (ROADMAP C-ref2): the B=16, C=32 mixed
# cell at 10x its planted time.
OUTLIER = dict(alpha=0.03125, beta=5.911982267626497e-06, a_s=0.015625,
               b_s=6.346129437201832e-07, seed=5)


def _outlier_samples(mod):
    grid = mod.CalibrationGrid.default()
    out = []
    for cell in grid.cells():
        tau = (OUTLIER["alpha"] + OUTLIER["beta"] * cell.chunk
               if cell.mode == "mixed"
               else OUTLIER["a_s"] + OUTLIER["b_s"] * cell.kv)
        out.append(mod.Sample(mode=cell.mode, batch=cell.batch,
                              chunk=cell.chunk, kv=cell.kv, tau=tau,
                              backend="roofline"))
    mixed = [s for s in out if s.mode == "mixed"]
    bad = mixed[OUTLIER["seed"] % len(mixed)]
    out[out.index(bad)] = mod.Sample(
        mode=bad.mode, batch=bad.batch, chunk=bad.chunk, kv=bad.kv,
        tau=bad.tau * 10.0, backend=bad.backend)
    return out


def test_fitter_bitwise_on_the_outlier_example():
    got = fit_surfaces(_outlier_samples(cal))
    want = ref_cal.fit_surfaces(_outlier_samples(ref_cal))
    assert {k: v.to_dict() for k, v in got.items()} == \
        {k: v.to_dict() for k, v in want.items()}
    assert isinstance(_outlier_samples(cal)[0], Sample)


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP C-ref2: the Huber fitter, copied bit for bit from the "
    "reference, loses the intercept to one outlier at the low-C end"))
def test_fitter_survives_one_outlier_recorded_example():
    fits = fit_surfaces(_outlier_samples(cal))
    assert fits["mix"].intercept == pytest.approx(
        OUTLIER["alpha"], rel=0.05, abs=0.05 * OUTLIER["alpha"])
