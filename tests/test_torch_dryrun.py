"""The dry run (``repro_torch.launch.dryrun``) held to the reference's.

The reference's dry run needs several XLA host devices, and importing
``repro.launch.dryrun`` asks for 512 of them, so it runs once, in one
subprocess with ``--xla_force_host_platform_device_count=4`` set before
``jax`` is imported (the ``ref`` fixture): reduced qwen2-0.5b at
decode_32k on a 1x1 and a 2x2 mesh, reduced mamba2-130m at decode_32k and
reduced qwen2-0.5b at train_4k on 1x1, the compiled 2x2 decode's HLO text,
and ``model_flops_reference`` of every cell.

Held:

* ``argument_bytes``, ``output_bytes`` and ``alias_bytes`` exactly equal
  to ``memory_analysis()``'s;
* ``model_flops_reference`` bitwise, all 40 cells, full and reduced;
* the global FLOPs within ``FLOPS_BAND`` of the reference's 1x1 count:
  XLA's cost model counts its fused elementwise and reduction work, the
  port's counter one FLOP per pointwise output element and reduced input
  element (91-98% of the reference's at these cells);
* the reference's 2x2 FLOPs per device (a quarter of its 1x1 count, its
  dot shapes split), so the port divides its global count by the mesh;
* ``collective_traffic`` bitwise on the reference's compiled HLO text;
* the port's collective lines, exact on a hand-counted 2x2 train cell.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import collective_traffic as ref_traffic
from repro.serving.steps import make_decode_step as ref_decode_step
from repro_torch.compat import make_mesh, resolve_device
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf_loop, roofline
from repro_torch.launch.hlo_analysis import collective_traffic
from repro_torch.models import model as TM
from repro_torch.models.params import tree_flatten
from repro_torch.serving.steps import make_decode_step
from test_torch_models import _caches_close, _close, _model

ROOT = Path(__file__).resolve().parents[1]
#: the port's global FLOPs over the reference's, at the cells held here
FLOPS_BAND = (0.88, 1.0)
CELLS = [("qwen2-0.5b", "decode_32k", "1x1"), ("qwen2-0.5b", "decode_32k", "2x2"),
         ("mamba2-130m", "decode_32k", "1x1"), ("qwen2-0.5b", "train_4k", "1x1")]
MESH = {"1x1": (1, 1), "2x2": (2, 2)}

_REF = r'''
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.compat import make_mesh
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import dryrun as D
from repro.launch.hlo_analysis import collective_traffic
meshes = {"1x1": make_mesh((1, 1), ("data", "model")),
          "2x2": make_mesh((2, 2), ("data", "model"))}
out = {"cells": {}, "dots": {}, "scanned_flops": {}, "model_flops": {}}
for arch, shape, tag in json.loads(sys.argv[1]):
    r = D.analyze_cell(get_config(arch, reduced=True), shape, meshes[tag],
                       strategy=D.STRATEGIES["baseline"])
    out["cells"][f"{arch}|{shape}|{tag}"] = {
        "memory": r["memory"], "flops": r["extrapolated"]["flops"]}
cfg = get_config("qwen2-0.5b", reduced=True)
for tag, mesh in meshes.items():
    comp = D.lower_cell(cfg, "decode_32k", mesh, unroll=False,
                        strategy={}).compile()
    text = comp.as_text()
    out["dots"][tag] = re.findall(r"= \w+\[([\d,]*)\]\S* dot\(", text)
    out["scanned_flops"][tag] = comp.cost_analysis()["flops"]
    if tag == "2x2":
        open(sys.argv[2], "w").write(text)
        out["traffic_2x2"] = collective_traffic(text)
for a in ARCHS:
    for red in (False, True):
        for s in SHAPES:
            out["model_flops"][f"{a}|{s}|{red}"] = D.model_flops_reference(
                get_config(a, reduced=red), s)
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    hlo = tmp_path_factory.mktemp("ref") / "decode_2x2.hlo"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REF, json.dumps(CELLS), str(hlo)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["hlo_2x2"] = hlo.read_text()
    return out


def _analyze(arch, shape, tag, strategy="baseline"):
    return D.analyze_cell(get_config(arch, reduced=True), shape,
                          make_mesh(MESH[tag], ("data", "model")),
                          strategy=D.STRATEGIES[strategy])


@pytest.mark.parametrize("arch,shape,tag", CELLS)
def test_memory_equals_the_reference(ref, arch, shape, tag):
    want = ref["cells"][f"{arch}|{shape}|{tag}"]["memory"]
    got = _analyze(arch, shape, tag)["memory"]
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert got[k] == want[k], k
    if (arch, tag) == ("qwen2-0.5b", "2x2"):
        assert got["argument_bytes"] == 818_216_000


@pytest.mark.parametrize("arch,shape,tag",
                         [c for c in CELLS if c[2] == "1x1"])
def test_global_flops_within_band_of_the_reference(ref, arch, shape, tag):
    want = ref["cells"][f"{arch}|{shape}|{tag}"]["flops"]
    got = _analyze(arch, shape, tag)["extrapolated"]["flops_global"]
    lo, hi = FLOPS_BAND
    assert lo * want <= got <= hi * want, got / want


def test_model_flops_reference_bitwise(ref):
    for a in ARCHS:
        for red in (False, True):
            for s in SHAPES:
                got = D.model_flops_reference(get_config(a, reduced=red), s)
                assert got == ref["model_flops"][f"{a}|{s}|{red}"], (a, s)


def test_reference_flops_are_per_device(ref):
    """The 2x2 cell's FLOPs are a quarter of the 1x1 cell's and every dot
    of its module is split: XLA's count is per device, as the reference's
    roofline says, so the port divides its global count by the mesh."""
    f11, f22 = ref["scanned_flops"]["1x1"], ref["scanned_flops"]["2x2"]
    assert f22 == pytest.approx(f11 / 4, rel=1e-2)
    d11, d22 = ref["dots"]["1x1"], ref["dots"]["2x2"]
    assert len(d11) == len(d22) > 0

    def size(dims):
        return int(np.prod([int(x) for x in dims.split(",") if x]))
    assert sum(map(size, d22)) * 2 <= sum(map(size, d11))
    rec = _analyze("qwen2-0.5b", "decode_32k", "2x2")["extrapolated"]
    assert rec["flops"] == rec["flops_global"] / 4
    assert rec["bytes"] == rec["bytes_global"] / 4


def test_collective_parser_bitwise_on_the_reference_hlo(ref):
    assert collective_traffic(ref["hlo_2x2"]) == ref["traffic_2x2"]
    assert collective_traffic(ref["hlo_2x2"]) == ref_traffic(ref["hlo_2x2"])


def test_collective_lines_hand_counted_2x2_train():
    """Reduced qwen2-0.5b (3 layers, d 64, 4 heads over 2 KV heads of 16,
    ff 160, vocab 512, tied, f32) at train_4k on data=2 x model=2 with
    remat: FSDP gathers a layer's leaf twice a step and scatters its grad
    once; the biases (replicated over data) all-reduce their grads; the
    row-split products (wo, w_down: 3 layers x (2 forwards + 1 backward)),
    the vocabulary-split lookup and the logits' input gradient all-reduce
    (B/2, S, d); the normalizer's max and sum (B/2, S)."""
    rec = _analyze("qwen2-0.5b", "train_4k", "2x2")
    g = "replica_groups=[2,2]<=[4]"
    want = {}
    for shape, n_ag, n_rs in (("256,64", 1, 1), ("64", 13, 7),
                              ("64,2,16", 6, 3), ("64,1,16", 12, 6),
                              ("2,16,64", 6, 3), ("64,80", 12, 6),
                              ("80,64", 6, 3)):
        want[f"%c = f32[{shape}] all-gather(%p), {g}"] = n_ag
        want[f"%c = f32[{shape}] reduce-scatter(%p), {g}"] = n_rs
    for shape, n in (("2,16", 3), ("1,16", 6), ("128,4096,64", 20),
                     ("128,4096", 2)):
        want[f"%c = f32[{shape}] all-reduce(%p), {g}"] = n
    assert dict(map(tuple, rec["collective_lines"])) == want
    coll = rec["scanned_coll"]
    assert coll["counts"]["all-gather"] == 56
    assert coll["all-reduce"] == (20 * 128 * 4096 * 64 + 2 * 128 * 4096
                                  + 3 * 32 + 6 * 16) * 4 * 2 * 0.5


@pytest.mark.parametrize("strategy", sorted(D.STRATEGIES))
def test_every_strategy_traces(strategy):
    """Each strategy on reduced deepseek-v3 (MLA, dense and MoE layers) at
    the production mesh, at train_4k for the training strategies and
    decode_32k for the rest."""
    shape = ("train_4k" if strategy in ("no_remat", "batch_2d", "dp_all")
             else "decode_32k")
    rec = D.analyze_cell(get_config("deepseek-v3-671b", reduced=True), shape,
                         D.make_production_mesh(),
                         strategy=D.STRATEGIES[strategy])
    assert rec["extrapolated"]["flops"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["device"] == "meta"
    hint = "moe_dispatch_hint" in D.STRATEGIES[strategy]
    assert (rec.get("moe_dispatch_hint") == "not applied") == hint


def test_run_cell_records(tmp_path, monkeypatch):
    from repro.configs import skip_reason as ref_skip

    rec = D.run_cell("qwen2-0.5b", "long_500k", multi_pod=False,
                     out_dir=tmp_path)
    from repro.configs import get_config as ref_get_config
    assert rec["skipped"] == ref_skip(ref_get_config("qwen2-0.5b"),
                                      "long_500k")
    path = tmp_path / "qwen2-0.5b__long_500k__pod16x16__baseline.json"
    assert json.loads(path.read_text()) == rec

    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(D, "analyze_cell", boom)
    rec = D.run_cell("qwen2-0.5b", "decode_32k", multi_pod=False,
                     out_dir=tmp_path)
    assert rec["ok"] is False and rec["error"] == "RuntimeError: boom"
    assert "boom" in rec["traceback"]


def test_cli_roofline_and_perf_loop(tmp_path, capsys):
    """The dry run's CLI on a full-width cell, the roofline over its record
    at the card's table, and the perf loop over three strategies."""
    D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out",
            str(tmp_path)])
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__pod16x16__"
                                  "baseline.json").read_text())
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["scanned"] == {k: rec["extrapolated"][k]
                              for k in ("flops", "bytes")}
    roofline.main(["--dir", str(tmp_path), "--hw", "h100"])
    out = capsys.readouterr().out
    assert "| qwen2-0.5b | decode_32k | baseline |" in out
    t = roofline.roofline_terms(rec, roofline.hw_constants("h100"))
    assert t["memory_s"] == rec["extrapolated"]["bytes"] / 3.35e12
    assert t["collective_s"] == rec["extrapolated"]["coll_total"] / 25e9
    perf_loop.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                    "--strategies", "baseline,kv_heads,kv_int8", "--out",
                    str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[2:]] == ["baseline", "kv_heads",
                                                  "kv_int8"]


# ------------------------------------------------ make_decode_step(masked)


def test_decode_step_unmasked_matches_the_reference():
    """``masked=False`` against the reference's at reduced qwen2-0.5b with
    every slot active, after a prefill; f32 1e-5.  With every slot active
    ``masked=True`` gives the same state to the last bit."""
    ref_cfg, cfg, rp, tp = _model("qwen2-0.5b")
    import jax.numpy as jnp
    from repro.models import model as RM

    B, S, P = 3, 64, 20
    rng = np.random.default_rng(5)
    toks = rng.integers(2, cfg.vocab_size, size=(B, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P))
    _, rc = RM.forward_prefill(ref_cfg, rp, jnp.asarray(toks),
                               jnp.asarray(pos),
                               RM.init_cache(ref_cfg, B, S, jnp.float32))
    rstate = {"caches": rc, "length": jnp.full((B,), P, jnp.int32),
              "last_token": jnp.asarray(toks[:, -1]),
              "active": jnp.ones((B,), bool)}
    want, want_tok = ref_decode_step(ref_cfg, masked=False)(rp, rstate)

    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rc)
    tstate = {"caches": tc, "length": torch.full((B,), P, dtype=torch.int32),
              "last_token": torch.from_numpy(toks[:, -1].copy()),
              "active": torch.ones((B,), dtype=torch.bool)}
    got, got_tok = make_decode_step(cfg, masked=False)(tp, tstate)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    _caches_close(got["caches"], want["caches"], 1e-5)
    for k in ("length", "last_token", "active"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    masked, m_tok = make_decode_step(cfg, masked=True)(tp, tstate)
    assert torch.equal(m_tok, got_tok)
    for a, b in zip(tree_flatten(masked), tree_flatten(got)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


# ------------------------------------------------------- the meta device


def test_meta_reaches_each_plain_version():
    """A meta input takes each kernel wrapper's plain route and comes back
    a meta tensor of the right shape; the default device still needs a
    card."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    assert resolve_device("meta") == torch.device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    m = dict(device="meta")
    q = torch.empty(2, 1, 4, 16, **m)
    kc = torch.empty(2, 32, 2, 16, **m)
    out = decode_attention(q, kc, kc, torch.empty(2, dtype=torch.int32, **m))
    assert out.device.type == "meta" and out.shape == q.shape
    q = torch.empty(2, 24, 4, 16, **m)
    kv = torch.empty(2, 24, 2, 16, **m)
    out = prefill_attention(q, kv, kv, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    x = torch.empty(1, 32, 3, 8, **m)
    bm = torch.empty(1, 32, 16, **m)
    y, h = ssd_scan(x, bm, bm, torch.empty(1, 32, 3, **m))
    assert y.device.type == "meta" and y.shape == x.shape
    assert h.device.type == "meta" and h.shape == (1, 3, 8, 16)


@pytest.mark.parametrize("arch,layers", [("recurrentgemma-2b", 5),
                                         ("deepseek-v3-671b", 6)])
def test_remat_over_several_segments(arch, layers):
    """With more than one segment, ``remat=True`` recomputes each repeat
    with its own segment's blocks: loss and grads equal ``remat=False``'s
    (f32, 1e-6).  The dry run's full-size train cells of recurrentgemma-2b
    and deepseek-v3 have two segments."""
    from repro_torch.models.config import segment_layers
    from repro_torch.training.train_step import make_loss, value_and_grad

    cfg = get_config(arch, reduced=True).replace(n_layers=layers)
    assert len(segment_layers(cfg.block_specs())) == 2
    gen = torch.Generator().manual_seed(3)
    params = TM.init_model(cfg, gen, device="cpu")
    toks = torch.randint(2, cfg.vocab_size, (2, 24), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    l0, g0 = value_and_grad(make_loss(cfg, remat=False), params, batch)
    l1, g1 = value_and_grad(make_loss(cfg, remat=True), params, batch)
    assert torch.allclose(l0, l1, rtol=1e-6, atol=0)
    for (p0, a), (p1, b) in zip(tree_flatten(g0), tree_flatten(g1)):
        assert p0 == p1
        _close(b, a.numpy(), 1e-6)
