"""The port's training path held to the JAX package on the CPU.

``repro_torch.models.model.loss_fn`` and its grads, ``training``'s
optimizer, data, train step and ``checkpoint``'s manager against
``repro.models``/``repro.training``/``repro.checkpoint``, on the same
weights (``params_from_numpy``, ``train_state_from_numpy``) and the same
numpy draws; and ``tests/test_training.py``'s corpus on the port.

Tolerances:

* ``loss_fn`` and its grads, f32: 1e-5 of the largest magnitude (per
  leaf), summation order only.  The SSM runs the plain scan on the CPU.
* ``loss_fn`` and its grads with bf16 activations (qwen2, mamba2): the
  loss 1e-3 relative, each grad leaf 0.1 in relative L2 norm, bf16
  noise: the reference's own bf16 grads are up to 8.9% from its f32
  grads on the same input.
* ``lr_at`` and ``opt_update``, f32: 1e-6 relative (``pow``/``cos``
  and the global norm's per-leaf sums differ in the last bits); bf16
  moments within one bf16 rounding step (2**-8 relative).
* ``SyntheticLM``, checkpoints and a CPU restart: bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCkpt
from repro.configs import get_config as ref_get_config
from repro.launch import train as ref_train
from repro.models import model as RM
from repro import training as RT
from repro.training import optimizer as ROpt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.prefill_attention import ops as pf_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as T
from repro_torch.models import attention as TA
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.params import (params_from_numpy, tree_map,
                                       train_state_from_numpy)
from repro_torch.training import (DataConfig, OptConfig, SyntheticLM,
                                  init_train_state, make_batch_iterator,
                                  make_train_step)
from repro_torch.training import optimizer as TOpt
from repro_torch.training.train_step import make_loss, value_and_grad

LOSS_ARCHS = ["qwen2-0.5b", "mamba2-130m", "deepseek-v3-671b",
              "whisper-base", "paligemma-3b"]
REL = 1e-5
OPT_REL = 1e-6
BF16_LOSS_REL = 1e-3
BF16_GRAD_L2 = 0.1


def _close(got, want, rel):
    """|got - want| <= rel x (|want| + max |want|)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _batch(cfg, B, S, seed=0):
    """Tokens, labels (a few masked) and the config's stubs, numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if cfg.vision is not None:
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.vision.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.encoder.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _moe_drops(arch):
    """deepseek-v3 at capacity factor 0.25: by pigeonhole some expert
    gets more copies than its capacity, so tokens are dropped."""
    if arch != "deepseek-v3-671b":
        return {}
    moe = get_config(arch, reduced=True).moe
    return {"moe": moe.__class__(**{**moe.__dict__, "capacity_factor": 0.25})}


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """MLA, MoE with dropped tokens and the MTP head (deepseek-v3), the
    plain SSD scan (mamba2), the encoder (whisper) and the prefix-LM
    (paligemma): the loss and every grad leaf at f32 1e-5."""
    over = _moe_drops(arch)
    ref_cls = ref_get_config(arch, reduced=True).moe.__class__
    ref_over = ({"moe": ref_cls(**{
        k: v for k, v in over["moe"].__dict__.items()
        if k in ref_cls.__dataclass_fields__})} if over else {})
    rcfg = ref_get_config(arch, reduced=True).replace(**ref_over)
    cfg = get_config(arch, reduced=True).replace(**over)
    B, S = 2, 32
    if over:
        assert B * S * cfg.moe.top_k / cfg.moe.n_experts \
            > TMoE._capacity(cfg.moe, B * S)
    assert cfg.mtp == (arch == "deepseek-v3-671b")
    rp = jax.tree.map(np.asarray, RM.init_model(rcfg, jax.random.PRNGKey(1)))
    batch = _batch(rcfg, B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.make_loss(rcfg, remat=False)(p, jb)))(rp)
    loss, grads = value_and_grad(make_loss(cfg, remat=True),
                                 params_from_numpy(rp, "cpu"),
                                 _torch_batch(batch))
    _close(loss, want_loss, REL)
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree.leaves(grads))
    for path, w in flat:
        g = _at(grads, path)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        _close(g, w, REL)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_bf16_loss_and_grads_match_reference(arch):
    """The configs' own ``param_dtype``, bf16 activations over f32
    weights: the loss within BF16_LOSS_REL and every grad leaf within
    BF16_GRAD_L2 (relative L2) of ``jax.value_and_grad`` of the
    reference on the same weights and batch.  Each side rounds at its
    own points (the port's SSD scan sums in f32 and rounds y once, the
    reference rounds its intra-chunk weights to bf16), so the two are
    as far apart as bf16 noise puts them: on this input the reference's
    own bf16 step is up to 8.9% (mamba2) and 2.8% (qwen2) from its f32
    step (``tests/torch_bf16_grad_gap.py --reduced``)."""
    rcfg = ref_get_config(arch, reduced=True).replace(param_dtype="bfloat16")
    cfg = get_config(arch, reduced=True).replace(param_dtype="bfloat16")
    rp = jax.tree.map(np.asarray, RM.init_model(rcfg, jax.random.PRNGKey(1)))
    batch = _batch(rcfg, 2, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.make_loss(rcfg, remat=False)(p, jb)))(rp)
    loss, grads = value_and_grad(make_loss(cfg), params_from_numpy(rp, "cpu"),
                                 _torch_batch(batch))
    assert abs(float(loss) - float(want_loss)) \
        <= BF16_LOSS_REL * abs(float(want_loss))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree.leaves(grads))
    for path, w in flat:
        g = _at(grads, path)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        w = np.asarray(w, np.float32)
        l2 = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert l2 <= BF16_GRAD_L2, (path, l2)


def _steep_mamba2():
    """Reduced mamba2 with A_log = 2 (A = -e**2): within a 32-token chunk
    cum_t - cum_s reaches far past 88.7 above the diagonal, where
    exp overflows f32, as it does at mamba2-130m's own 256-token chunk
    with A_log = 0."""
    rcfg = ref_get_config("mamba2-130m", reduced=True)
    rp = jax.tree.map(np.asarray, RM.init_model(rcfg, jax.random.PRNGKey(1)))
    for seg in (k for k in rp if k.startswith("seg")):
        a = rp[seg]["b0"]["ssm"]["A_log"]
        rp[seg]["b0"]["ssm"]["A_log"] = np.full_like(a, 2.0)
    return rcfg, rp, _batch(rcfg, 2, 32)


@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="C-ref9: the reference's SSD chunk loop masks "
                          "exp(cum_t - cum_s) with jnp.where after the exp "
                          "(models/ssm.py:131), so where it overflows above "
                          "the diagonal the gradient is inf x 0 = NaN")
def test_c_ref9_reference_ssm_grads_are_finite_past_exp_overflow():
    rcfg, rp, batch = _steep_mamba2()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, g = jax.value_and_grad(
        lambda p: RT.make_loss(rcfg, remat=False)(p, jb))(rp)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(g))


def test_port_ssm_grads_are_finite_past_exp_overflow():
    """The port's chunk loop masks before the exp (``ssd_scan_plain``):
    the same loss as the reference, and finite grads, nonzero in every
    SSM leaf, where the reference's are NaN (C-ref9)."""
    rcfg, rp, batch = _steep_mamba2()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = RT.make_loss(rcfg, remat=False)(rp, jb)
    cfg = get_config("mamba2-130m", reduced=True)
    loss, grads = value_and_grad(make_loss(cfg), params_from_numpy(rp, "cpu"),
                                 _torch_batch(batch))
    _close(loss, want, REL)
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        assert torch.isfinite(g).all(), path
        if "ssm" in jax.tree_util.keystr(path):
            assert g.any(), path


def test_remat_changes_no_number():
    """Checkpointed recompute gives the very grads the plain backward
    does (the saving policy moves memory and time only)."""
    cfg = get_config("deepseek-v3-671b", reduced=True)
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = _torch_batch(_batch(cfg, 2, 16))
    l0, g0 = value_and_grad(make_loss(cfg, remat=False), params, batch)
    l1, g1 = value_and_grad(make_loss(cfg, remat=True), params, batch)
    assert torch.equal(l0, l1)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             g0, g1)


def test_train_mode_writes_no_cache(monkeypatch):
    """The serving path's in-place cache writers never run in train mode,
    and train mode refuses caches; ``init_params`` gives leaves that do
    not require grad, and a train step returns none that do."""
    def boom(*a, **k):
        raise AssertionError("a cache write ran in train mode")

    monkeypatch.setattr(TA, "_scatter", boom)
    monkeypatch.setattr(TMLA, "_scatter", boom)
    for arch in ("qwen2-0.5b", "deepseek-v3-671b", "whisper-base"):
        cfg = get_config(arch, reduced=True)
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 OptConfig(), device="cpu")
        leaves = jax.tree.leaves(state)
        assert not any(t.requires_grad for t in leaves)
        new, m = make_train_step(cfg, OptConfig())(
            state, _torch_batch(_batch(cfg, 2, 16)))
        assert torch.isfinite(m["loss"])
        assert not any(t.requires_grad or t.grad_fn is not None
                       for t in jax.tree.leaves(new))
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="train mode takes no caches"):
        TM._run_segments(cfg, params, x, positions=pos, mode="train",
                         caches=TM.init_cache(cfg, 1, 8, device="cpu"))


def test_ssd_autograd_function_gives_the_plain_grads(monkeypatch):
    """B3's ``autograd.Function`` with its launch stood in for by the
    plain version (the CPU has no kernel): its input grads equal plain
    autograd's, only forwards count, and a checkpointed call's recompute
    counts again."""
    def launch(x, Bm, Cm, la, h0):
        ssd_ops.ssd_scan.launches += 1
        return ssd_ops.ssd_scan_plain(x, Bm, Cm, la, initial_state=h0)

    monkeypatch.setattr(ssd_ops, "_launch", launch)
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 40, 3, 16, 8

    def inputs():
        return [torch.from_numpy(a.astype(np.float32)).requires_grad_()
                for a in (rng.standard_normal((B, S, H, P)),
                          rng.standard_normal((B, S, N)),
                          rng.standard_normal((B, S, N)),
                          -np.abs(rng.standard_normal((B, S, H))) * 0.3,
                          rng.standard_normal((B, H, P, N)))]

    for with_state in (False, True):
        a = inputs()
        b = [t.detach().clone().requires_grad_() for t in a]
        h0a, h0b = (a[4], b[4]) if with_state else (None, None)
        n0 = ssd_ops.ssd_scan.launches
        y, h = ssd_ops._SSDScan.apply(*a[:4], h0a)
        assert ssd_ops.ssd_scan.launches == n0 + 1
        yw, hw = ssd_ops.ssd_scan_plain(*b[:4], initial_state=h0b)
        gy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
        (y * gy).sum().backward()
        (yw * gy).sum().backward()
        assert ssd_ops.ssd_scan.launches == n0 + 1
        for t, w in zip(a[:4 + with_state], b[:4 + with_state]):
            torch.testing.assert_close(t.grad, w.grad, rtol=0, atol=0)
        # the state's grad too, when only the state is used
        for t in a + b:
            t.grad = None
        _, h = ssd_ops._SSDScan.apply(*a[:4], h0a)
        h.sum().backward()
        _, hw = ssd_ops.ssd_scan_plain(*b[:4], initial_state=h0b)
        hw.sum().backward()
        for t, w in zip(a[:4 + with_state], b[:4 + with_state]):
            torch.testing.assert_close(t.grad, w.grad, rtol=0, atol=0)
    a = inputs()
    n0 = ssd_ops.ssd_scan.launches
    y, _ = torch.utils.checkpoint.checkpoint(
        lambda *t: ssd_ops._SSDScan.apply(*t, None), *a[:4],
        use_reentrant=False)
    y.sum().backward()
    assert ssd_ops.ssd_scan.launches == n0 + 2  # forward + recompute


def test_attention_kernels_refuse_inputs_that_require_grad():
    """B1 and B2 have no backward: with grad mode on they raise on an
    input that requires grad (on every device: the CPU's plain version
    refuses what the kernel would), and run under ``no_grad``."""
    q = torch.randn(2, 8, 4, 16, requires_grad=True)
    k = torch.randn(2, 8, 2, 16)
    with pytest.raises(RuntimeError, match="prefill_attention has no "
                                           "backward"):
        pf_ops.prefill_attention(q, k, k)
    qd = torch.randn(2, 1, 4, 16, requires_grad=True)
    kv_len = torch.tensor([8, 5], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="decode_attention has no "
                                           "backward"):
        dec_ops.decode_attention(qd, k, k, kv_len)
    with torch.no_grad():
        assert pf_ops.prefill_attention(q, k, k).shape == q.shape
        assert dec_ops.decode_attention(qd, k, k, kv_len).shape == qd.shape


def test_loss_decreases_small_model():
    cfg = get_config("qwen2-0.5b", reduced=True)
    opt = OptConfig(lr=2e-3, warmup_steps=5, total_steps=60)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), opt,
                             device="cpu")
    step = make_train_step(cfg, opt)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                seq_len=64))
    losses = []
    for i in range(30):
        state, m = step(state, _torch_batch(ds.batch_at(i)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_microbatch_equals_full_batch_grads():
    """Grad accumulation over microbatches == single big batch (linearity)."""
    cfg = get_config("qwen2-0.5b", reduced=True)
    opt = OptConfig()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), opt,
                             device="cpu")
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                seq_len=32))
    b = _torch_batch(ds.batch_at(0))
    s1, m1 = make_train_step(cfg, opt, microbatches=1)(state, b)
    s2, m2 = make_train_step(cfg, opt, microbatches=2)(state, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b_ in zip(jax.tree.leaves(s1["params"]),
                     jax.tree.leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5)


def test_train_step_matches_reference_with_microbatches():
    """One step with 2 microbatches from a carried state: the loss, the
    accumulated grads (caught by ``grad_transform`` in both packages) and
    the grad norm at 1e-5."""
    rcfg = ref_get_config("mamba2-130m", reduced=True)
    cfg = get_config("mamba2-130m", reduced=True)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    rs = jax.tree.map(np.asarray, RT.init_train_state(
        rcfg, jax.random.PRNGKey(2), ROpt.OptConfig(**kw)))
    batch = _batch(rcfg, 4, 32, seed=5)
    caught = {}

    def catch_ref(grads):  # inside jit: the host gets them by callback
        jax.debug.callback(lambda g: caught.__setitem__("ref", g), grads)
        return grads

    def catch_port(grads):
        caught["port"] = grads
        return grads

    rnew, rm = jax.jit(RT.make_train_step(
        rcfg, ROpt.OptConfig(**kw), microbatches=2,
        grad_transform=catch_ref))(
        rs, {k: jnp.asarray(v) for k, v in batch.items()})
    jax.block_until_ready(rnew)
    new, m = make_train_step(cfg, OptConfig(**kw), microbatches=2,
                             grad_transform=catch_port)(
        train_state_from_numpy(rs, "cpu"), _torch_batch(batch))
    _close(m["loss"], rm["loss"], REL)
    _close(m["grad_norm"], rm["grad_norm"], REL)
    for path, w in jax.tree_util.tree_leaves_with_path(caught["ref"]):
        _close(_at(caught["port"], path), w, REL)
    assert int(new["opt"]["step"]) == int(rnew["opt"]["step"]) == 1


def test_checkpoint_restart_resumes_exactly(tmp_path, capsys):
    """Kill/restart: the resumed run's losses are the uninterrupted
    run's, bit for bit on the CPU (step, moments and data cursor come
    back exactly)."""
    cfg = T.preset_100m().replace(n_layers=2, d_model=64, d_ff=128,
                                  vocab_size=512)
    kw = dict(steps=8, batch=2, seq_len=32, ckpt_every=4, log_every=100,
              device="cpu")
    full = T.run_training(cfg, ckpt_dir=None, **kw)
    d = str(tmp_path / "ck")
    T.run_training(cfg, ckpt_dir=d, **dict(kw, steps=4))
    resumed = T.run_training(cfg, ckpt_dir=d, **kw)
    assert "resumed from step 4 (cursor=4)" in capsys.readouterr().out
    assert resumed["losses"] == full["losses"][4:]
    assert resumed["final_loss"] == full["final_loss"]


def test_restart_with_bf16_moments_resumes(tmp_path):
    """The port restores its bf16-moment checkpoint and resumes bit for
    bit (the reference cannot: C-ref8, below)."""
    cfg = T.preset_100m().replace(n_layers=1, d_model=32, d_ff=64,
                                  vocab_size=256)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=4,
                    state_dtype="bfloat16")
    kw = dict(steps=4, batch=2, seq_len=16, ckpt_every=2, log_every=100,
              opt=opt, device="cpu")
    full = T.run_training(cfg, ckpt_dir=None, **kw)
    d = str(tmp_path / "ck")
    T.run_training(cfg, ckpt_dir=d, **dict(kw, steps=2))
    state, _ = CheckpointManager(d).restore(device="cpu")
    assert state["opt"]["m"]["embed"].dtype == torch.bfloat16
    resumed = T.run_training(cfg, ckpt_dir=d, **kw)
    assert resumed["losses"] == full["losses"][2:]


@pytest.mark.xfail(strict=True, raises=TypeError,
                   reason="C-ref8: the reference's run_training cannot "
                          "resume from its own bf16-moment checkpoint "
                          "(np.load gives |V2 words, jnp.asarray refuses "
                          "them)")
def test_c_ref8_reference_resumes_with_bf16_moments(tmp_path):
    cfg = ref_train.preset_100m().replace(n_layers=1, d_model=32, d_ff=64,
                                          vocab_size=256)
    opt = ROpt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=4,
                         state_dtype="bfloat16")
    kw = dict(steps=4, batch=2, seq_len=16, ckpt_every=2, log_every=100,
              opt=opt, ckpt_dir=str(tmp_path / "ck"))
    ref_train.run_training(cfg, **dict(kw, steps=2))
    ref_train.run_training(cfg, **kw)


def _moved_state(rcfg, ropt, seed):
    """A reference train state one step in: its params, random moments
    (v > 0) in ``ropt.state_dtype``, step 1."""
    state = RT.init_train_state(rcfg, jax.random.PRNGKey(seed), ropt)
    rng = np.random.default_rng(seed)

    def moment(m, positive):
        a = rng.standard_normal(m.shape).astype(np.float32) * 1e-2
        return jnp.asarray(np.abs(a) if positive else a).astype(m.dtype)

    opt = state["opt"]
    return {"params": state["params"],
            "opt": {"m": jax.tree.map(lambda m: moment(m, False), opt["m"]),
                    "v": jax.tree.map(lambda v: moment(v, True), opt["v"]),
                    "step": jnp.ones((), jnp.int32)}}


def _bits(x):
    """A leaf's raw bytes (a bf16 leaf as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, state_dtype):
    """A train state saved by either package restores in the other leaf
    for leaf: same paths, shapes, manifest dtypes, bytes and metadata."""
    rcfg = ref_get_config("qwen2-0.5b", reduced=True)
    ropt = ROpt.OptConfig(state_dtype=state_dtype)
    rstate = _moved_state(rcfg, ropt, seed=3)
    RefCkpt(tmp_path / "ref").save(7, rstate, metadata={"cursor": 7})
    got, meta = CheckpointManager(tmp_path / "ref").restore(device="cpu")
    assert meta == {"cursor": 7}
    flat = jax.tree_util.tree_leaves_with_path(rstate)
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        g = _at(got, path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        assert tuple(g.shape) == w.shape and _bits(g) == _bits(w), path

    CheckpointManager(tmp_path / "port").save(7, got,
                                              metadata={"cursor": 7})
    back, meta = RefCkpt(tmp_path / "port").restore()
    assert meta == {"cursor": 7}
    for path, w in flat:
        b = _at(back, path)
        assert b.shape == w.shape and _bits(b) == _bits(w), path
    m_ref, m_port = (json.loads((tmp_path / d / "step_00000007" /
                                 "manifest.json").read_text())
                     for d in ("ref", "port"))
    assert {k: {**v, "host": 0} for k, v in m_ref["leaves"].items()} \
        == m_port["leaves"]


def test_checkpoint_manager_keeps_last_k_and_verifies(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16),
                  torch.tensor(3, dtype=torch.int32)]}
    for s in (1, 2, 3):
        mgr.save(s, tree, metadata={"s": s})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    got, meta = mgr.restore(device="cpu")
    assert meta == {"s": 3}
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"][0], tree["b"][0])
    assert got["b"][1].dtype == torch.int32 and int(got["b"][1]) == 3
    # a flipped byte fails the hash
    npz = tmp_path / "step_00000003" / "host00.npz"
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["a"] = arrays["a"] + 1
    np.savez(npz, **arrays)
    with pytest.raises(IOError, match="corruption in leaf a"):
        mgr.restore(device="cpu")


def test_data_pipeline_deterministic_resume():
    cfg = DataConfig(vocab_size=1000, batch=2, seq_len=64, seed=3)
    a = SyntheticLM(cfg).batch_at(17)
    b = SyntheticLM(cfg).batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    # next-token alignment
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("vocab,batch,seq,seed", [(1000, 2, 64, 3),
                                                  (512, 8, 256, 0),
                                                  (8192, 3, 1100, 7)])
def test_synthetic_lm_is_the_reference(vocab, batch, seq, seed):
    rcfg = RT.DataConfig(vocab_size=vocab, batch=batch, seq_len=seq,
                         seed=seed)
    cfg = DataConfig(vocab_size=vocab, batch=batch, seq_len=seq, seed=seed)
    ref, port = RT.SyntheticLM(rcfg), SyntheticLM(cfg)
    for cursor in (0, 1, 17):
        a, b = ref.batch_at(cursor), port.batch_at(cursor)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for (c1, b1), (c2, b2), _ in zip(RT.make_batch_iterator(rcfg, 5),
                                     make_batch_iterator(cfg, 5), range(2)):
        assert c1 == c2
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


@pytest.mark.parametrize("schedule", ["cosine", "const"])
def test_lr_at_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=20, total_steps=200, schedule=schedule)
    rc, pc = ROpt.OptConfig(**kw), OptConfig(**kw)
    for step in (0, 19, 20, 110, 200):
        want = np.float32(ROpt.lr_at(rc, jnp.asarray(step, jnp.int32)))
        got = TOpt.lr_at(pc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=OPT_REL)
        want_py = np.float32(ROpt.lr_at(rc, step))
        np.testing.assert_allclose(float(TOpt.lr_at(pc, step)), want_py,
                                   rtol=OPT_REL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_opt_update_matches_reference(state_dtype):
    """One AdamW step from a carried state with nonzero moments at step
    1, clipped (the grads' norm is above clip_norm)."""
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10,
              state_dtype=state_dtype)
    rcfg = ref_get_config("qwen2-0.5b", reduced=True)
    ropt, opt = ROpt.OptConfig(**kw), OptConfig(**kw)
    rs = jax.tree.map(np.asarray, _moved_state(rcfg, ropt, seed=4))
    rng = np.random.default_rng(9)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), rs["params"])
    rp, ro, rm = jax.jit(ROpt.opt_update, static_argnums=3)(
        rs["params"], grads, rs["opt"], ropt)
    state = train_state_from_numpy(rs, "cpu")
    assert state["opt"]["m"]["embed"].dtype == getattr(torch, state_dtype)
    p, o, m = TOpt.opt_update(state["params"], params_from_numpy(grads, "cpu"),
                              state["opt"], opt)
    assert float(rm["grad_norm"]) > opt.clip_norm
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=OPT_REL)
    np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=OPT_REL)
    assert int(o["step"]) == int(ro["step"]) == 2
    mom_rel = OPT_REL if state_dtype == "float32" else 2.0 ** -8
    for path, w in jax.tree_util.tree_leaves_with_path(rp):
        np.testing.assert_allclose(_at(p, path).numpy(), np.asarray(w),
                                   rtol=OPT_REL, atol=OPT_REL)
    for key in ("m", "v"):
        for path, w in jax.tree_util.tree_leaves_with_path(ro[key]):
            g = _at(o[key], path)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            _close(g, np.asarray(w, np.float32), mom_rel)


def test_example_train_small_runs(tmp_path, monkeypatch, capsys):
    """``examples/torch_train_small.py``'s ``main`` on a reduced config,
    4 steps on the CPU, with a checkpoint and a resume."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_train_small.py"
    spec = importlib.util.spec_from_file_location("torch_train_small", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = ["--reduced", "--steps", "4", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck")]
    out = mod.main(args)
    assert len(out["losses"]) == 4 and np.isfinite(out["final_loss"])
    assert "over 4 steps" in capsys.readouterr().out
    assert CheckpointManager(tmp_path / "ck").latest_step() == 4


def test_train_cli_on_the_cpu(capsys):
    T.main(["--arch", "mamba2-130m", "--reduced", "--steps", "2",
            "--batch", "2", "--seq-len", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss:" in out
