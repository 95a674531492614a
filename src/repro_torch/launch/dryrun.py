"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``.

The reference's ``launch/dryrun`` lowers and compiles each cell with XLA's
SPMD partitioner over 256 / 512 host devices and reads the compiled
module.  The port has no SPMD compiler.  It builds each cell's step
(``make_train_step``, ``make_prefill_step`` or
``make_decode_step(masked=False)``) and runs it once on PyTorch's
``meta`` device at the cell's global shapes -- shapes and dtypes, no
data, no allocation -- and derives the record from that trace and from
the layout the strategy's rules give each leaf.  The record keeps the
reference's keys; here is what they hold:

* ``extrapolated.flops`` / ``.bytes``: per-device counts, the global count
  over ``n_devices``; that is what
  :func:`repro_torch.launch.roofline.roofline_terms` reads.
  ``flops_global`` / ``bytes_global`` sit beside them.  FLOPs are those of
  the matmuls (``torch.utils.flop_counter``'s formulas) plus the
  elementwise and reduction work as XLA's cost model counts it: one per
  output element of a pointwise aten op (none for copies, selects, logic
  and transcendentals, which XLA counts apart), one per input element of
  a reduction, four for the softmax family.  Bytes sum the operand and result bytes of every aten
  op that is not a view: the eager counterpart of XLA's "bytes accessed",
  with no fusion.
* ``scanned`` holds the same counts as ``extrapolated``: the port's layer
  loop is unrolled, so every layer is counted, and the reference's
  per-segment extrapolation (``make_variant`` and its unrolled compiles)
  has nothing to correct.  ``--no-variants`` is accepted and changes
  nothing.
* ``memory.argument_bytes``: the per-device shard bytes of every input
  leaf under its spec (params, AdamW moments, caches, decode state,
  batch), uneven splits rounded up, as XLA's ``memory_analysis`` counts
  them.  ``output_bytes`` counts the outputs the same way plus 8 bytes a
  result leaf (XLA's result tuple holds a pointer per leaf);
  ``alias_bytes`` the donated inputs, as the reference donates them.
  ``temp_bytes``: the peak of the live bytes that the trace allocated,
  less its outputs, divided by the batch split (``temp_basis``); every
  storage counts from its creation until it is freed.
* Collectives: the port runs no SPMD program, so there is none to parse.
  The dry run counts the collectives that the layout makes necessary at
  the least, writes one HLO-form line for each (``collective_lines``:
  each distinct line with its count), and
  :func:`repro_torch.launch.hlo_analysis.collective_traffic` parses them:

  - train: each leaf sharded over a batch (FSDP) axis gets one all-gather
    of the leaf over that axis per forward (a second under ``remat``) and
    one reduce-scatter of its gradient; each leaf replicated over a batch
    axis gets one all-reduce of its gradient over it.  A stacked leaf
    does so once a layer.
  - every kind: each product whose contracting dimension is split over a
    mesh axis gets one all-reduce of its output per forward, and in train
    one more for the input gradient of its partner.  These are the
    row-split output projections, the experts' down projection (the
    combine sums over the expert axis), a vocabulary-split embedding
    lookup, and the logits' normalizer (max and sum) when the vocabulary
    is split, with the input gradient of the logits product in train.
  - decode: where a cache's sequence axis is split (baseline), the
    softmax's max, sum and output are all-reduced over that axis, for
    each attention layer.

  GSPMD's own reshardings are not modelled (e.g. moving K/V from a
  head-split projection into a sequence-split cache): the figure is a
  floor.
* ``moe_dispatch_hint`` is a GSPMD sharding constraint with no
  counterpart on one card (ROADMAP C).  A strategy that sets it keeps
  its other choices, and the record says ``"not applied"``.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
    python -m repro_torch.launch.dryrun ... --strategy <name>   # perf loop
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 skip_reason)
from repro_torch.launch.hlo_analysis import collective_traffic
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (DEFAULT_RULES, _walk, abstract_params,
                                       partition_specs)
from repro_torch.serving.steps import make_decode_step, make_prefill_step
from repro_torch.training.optimizer import OptConfig, opt_init
from repro_torch.training.sharding import (_axis_size, auto_demote,
                                           batch_spec, make_rules)
from repro_torch.training.train_step import make_train_step

__all__ = ["ARTIFACTS", "STRATEGIES", "build_rules", "cache_pspecs",
           "trace_cell", "analyze_cell", "model_flops_reference", "run_cell",
           "main"]

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


# --------------------------------------------------------------- strategies
#
# A strategy is a named set of sharding / step-construction choices; the
# perf loop iterates over these.  The reference's table, unchanged.

STRATEGIES: dict[str, dict] = {
    # paper-faithful baseline: TP over "model", FSDP over "data" for train,
    # serving caches sharded (batch -> data, seq -> model).
    "baseline": {},
    # decode: shard the KV cache over kv_heads instead of seq
    "kv_heads": {"cache_seq_axis": None, "cache_heads_axis": "model"},
    # decode: int8 KV cache with per-(token, head) scales (~2x less HBM)
    "kv_int8": {"kv_quant": True},
    # train: no remat (more memory, fewer FLOPs) -- ablation point
    "no_remat": {"remat": False},
    # train: 2D sharded batch (batch over data+model) for giant-batch cells
    "batch_2d": {"batch_over_model": True},
    # moe: expert parallelism over the whole pod (1 expert-shard per chip)
    "expert_ep": {"moe_expert_axis": ("data", "model")},
    # moe: align the dispatch buffer's capacity dim with the token axis so
    # the scatter stays local (kills GSPMD's buffer-sized all-reduces)
    "moe_dispatch": {"moe_dispatch_hint": ("model", "data")},
    # combined serving fix for giant MoEs: pod-wide EP + local dispatch
    "ep_dispatch": {"moe_expert_axis": ("data", "model"),
                    "moe_dispatch_hint": (("data", "model"), None)},
    # combined: pod-wide EP + local dispatch + int8 latent/KV cache
    "ep_dispatch_int8": {"moe_expert_axis": ("data", "model"),
                         "moe_dispatch_hint": (("data", "model"), None),
                         "kv_quant": True},
    # small-model training: pure 256-way data parallelism (params
    # replicated).  Constraining only the *inputs* to a 2D batch is not
    # enough -- GSPMD re-shards activations to match FSDP/TP weight
    # layouts -- so this also replicates every weight rule.
    "dp_all": {"replicate_params": True, "batch_over_model": True},
    # moe: tighter capacity factor (1.05): ~16% less dispatch-buffer
    # traffic at the cost of a little token dropping under skew
    "moe_cap105": {"moe_dispatch_hint": ("model", "data"),
                   "moe_capacity": 1.05},
    # few-expert MoE serving fit: shard the expert FF dim over the whole
    # pod (grok-1: 8 experts can't split 256 ways, but d_ff=32768 can)
    "ff_pod": {"moe_expert_ff_axis": ("data", "model")},
}


# ------------------------------------------------------------- shardings
#
# A spec is a tuple with one entry per dimension: None (replicated), a
# mesh-axis name, or a tuple of names (the reference's PartitionSpec).


def _dtype_of(cfg: ModelConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def build_rules(cfg: ModelConfig, mesh, kind: str, strategy: dict) -> dict:
    if strategy.get("replicate_params"):
        return {k: None for k in DEFAULT_RULES}
    fsdp = kind == "train"
    fsdp_axis = ("pod", "data") if ("pod" in mesh.axis_names and fsdp) else "data"
    overrides = {}
    if strategy.get("moe_expert_axis"):
        overrides["expert"] = strategy["moe_expert_axis"]
    if strategy.get("moe_expert_ff_axis"):
        overrides["expert"] = None
        overrides["expert_ff"] = strategy["moe_expert_ff_axis"]
    rules = make_rules(mesh, fsdp=fsdp, fsdp_axis=fsdp_axis,
                       overrides=overrides)
    defs = M.model_defs(cfg)
    rules = auto_demote(defs, rules, mesh)
    if (cfg.moe is not None and rules.get("expert") is None
            and rules.get("expert_ff") is None):
        # few-expert MoE (e.g. grok's 8 experts < 16-way axis): fall back to
        # tensor-parallel experts -- shard the expert FF dim instead of the
        # expert dim, so expert weights never replicate across the pod.
        trial = dict(rules)
        trial["expert_ff"] = "model"
        trial2 = auto_demote(defs, trial, mesh)
        if trial2.get("expert_ff") == "model":
            rules = trial2
    return rules


def _map_named(fn, tree, name=None):
    """``fn(leaf_name, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, name) for v in tree]
    return fn(name, tree)


def cache_pspecs(cfg: ModelConfig, caches_abs, mesh, strategy: dict,
                 batch_axis="data"):
    """Specs for the (segment-stacked) cache tree.

    Leaves are (layer_rep, B, ...): batch -> "data"; the sequence dim of
    attention/MLA caches -> "model" (baseline) so long KV shards; SSM/LRU
    states replicate over "model" unless head-divisible.
    """
    seq_ax = strategy.get("cache_seq_axis", "model")
    heads_ax = strategy.get("cache_heads_axis", None)
    msize = mesh.shape["model"]
    bsize = _axis_size(mesh, batch_axis) if batch_axis else 1

    def spec_for(name, leaf):
        shape = leaf.shape
        ax = [None] * len(shape)
        ax[1] = batch_axis if (batch_axis and shape[1] % bsize == 0) else None
        if name in ("k", "v", "xk", "xv"):
            # (rep, B, S, KV, D)
            if heads_ax and shape[3] % msize == 0:
                ax[3] = heads_ax
            elif seq_ax and shape[2] % msize == 0:
                ax[2] = seq_ax
        elif name in ("c_kv", "k_rope", "k_s", "v_s"):
            if seq_ax and shape[2] % msize == 0:
                ax[2] = seq_ax
        elif name in ("pos", "c_s", "r_s"):
            if seq_ax and shape[2] % msize == 0:
                ax[2] = seq_ax
        elif name == "ssm":  # (rep, B, H, P, N)
            if shape[2] % msize == 0:
                ax[2] = "model"
        elif name == "h":  # (rep, B, W)
            if shape[2] % msize == 0:
                ax[2] = "model"
        # conv caches replicate over model
        return tuple(ax)

    return _map_named(spec_for, caches_abs)


def _axes_of(entry) -> tuple:
    """The mesh-axis names of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _shard_shape(shape, spec, mesh) -> tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _axis_size(mesh, ax))
                 for n, ax in zip(shape, spec))


def _shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    return math.prod(_shard_shape(t.shape, spec, mesh)) * t.dtype.itemsize


def _paired(tree, specs):
    """(leaf, spec) over a tree and its spec tree (specs are tuples)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _paired(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _paired(v, s)
    else:
        yield tree, specs


def _tree_bytes(tree, specs, mesh) -> int:
    return sum(_shard_bytes(t, s, mesh) for t, s in _paired(tree, specs))


# ---------------------------------------------------------------- counters


#: pointwise aten ops that XLA's cost model gives no FLOP: copies, selects
#: and logic, and the transcendentals it counts apart
_NO_FLOP = frozenset({
    "clone", "copy", "copy_", "where", "masked_fill", "masked_fill_",
    "fill", "fill_", "bitwise_not", "bitwise_and", "bitwise_and_",
    "bitwise_or", "logical_not", "logical_and", "logical_or", "exp",
    "exp2", "expm1", "log", "log1p", "log2", "sin", "cos", "tanh",
    "sigmoid", "rsqrt", "sqrt", "erf"})
#: reductions: FLOPs per input element (the softmax family reduces twice,
#: subtracts and divides)
_REDUCE = {"sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
           "argmax": 1, "argmin": 1, "_softmax": 4, "_log_softmax": 4,
           "_softmax_backward_data": 4, "_log_softmax_backward_data": 4}


class _TraceCounter(TorchDispatchMode):
    """Counts every aten op of a trace: matmul FLOPs, the elementwise and
    reduction FLOPs XLA's cost model would count (one per output element
    of a pointwise op, one per input element of a reduction), operand +
    result bytes of non-view ops, and the live bytes of the storages the
    trace creates (peak and current)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}

    def _free(self, key, n):
        self.live -= n
        self._sizes.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func._overloadpacket.__name__
        if torch.Tag.pointwise in func.tags:
            if name not in _NO_FLOP:
                self.flops += sum(t.numel() for t in outs)
        elif name in _REDUCE:
            self.flops += _REDUCE[name] * args[0].numel()
        self.bytes += sum(t.numel() * t.element_size()
                          for t in tree_leaves((args, kwargs, outs))
                          if isinstance(t, torch.Tensor))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._sizes:
                n = st.nbytes()
                self._sizes[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key, n)
        return out


# ------------------------------------------------------------- collectives

_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.int8: "s8", torch.int32: "s32",
               torch.int64: "s64", torch.bool: "pred"}


def _hlo_line(dtype, shape, op: str, k: int, n: int) -> str:
    dims = ",".join(str(int(x)) for x in shape)
    return (f"%c = {_HLO_DTYPES[dtype]}[{dims}] {op}(%p), "
            f"replica_groups=[{n // k},{k}]<=[{n}]")


def _collective_lines(cfg: ModelConfig, kind: str, mesh, rules: dict,
                      pspecs: dict, dtype, bspec: tuple, b_local: int,
                      seq: int, remat: bool, caches=None,
                      cspecs=None) -> dict:
    """The least collectives the layout needs: {HLO-form line: count}."""
    n = math.prod(mesh.shape.values())
    lines: dict = {}

    def add(shape, op, axes, count, dt=dtype):
        k = _axis_size(mesh, tuple(axes)) if axes else 1
        if k > 1 and count > 0:
            line = _hlo_line(dt, shape, op, k, n)
            lines[line] = lines.get(line, 0) + count

    batch_axes = [a for a in _axes_of(bspec[0] if bspec else None)
                  if mesh.shape[a] > 1]
    train = kind == "train"
    n_prefix = cfg.vision.n_patches if cfg.vision is not None else 0
    s_dec = 1 if kind == "decode" else seq + n_prefix
    d = cfg.d_model
    specs = dict(_walk(pspecs))
    for path, pd in _walk(M.model_defs(cfg)):
        spec = specs[path]
        stacked = bool(pd.axes) and pd.axes[0] == "layer"
        reps = pd.shape[0] if stacked else 1
        shape, axes, spec1 = ((pd.shape[1:], pd.axes[1:], spec[1:])
                              if stacked else (pd.shape, pd.axes, spec))
        if path[0] == "encoder" and kind == "decode":
            continue
        if path[0] == "mtp" and not train:
            continue
        fwd = 2 if (train and remat and stacked and path[0] != "encoder") \
            else 1
        if train:
            used = {a for e in spec1 for a in _axes_of(e)}
            rs = [a for a in batch_axes if a in used]
            ar = [a for a in batch_axes if a not in used]
            full = _shard_shape(shape, [
                tuple(a for a in _axes_of(e) if a not in rs) or None
                for e in spec1], mesh)
            add(full, "all-gather", rs, reps * fwd)
            add(full, "reduce-scatter", rs, reps)
            add(_shard_shape(shape, spec1, mesh), "all-reduce", ar, reps)
        # products whose contracting dimension is split
        s_act = (cfg.encoder.n_frames if path[0] == "encoder"
                 else seq if path[0] == "mtp" else s_dec)
        name = path[-1]
        if path == ("embed",):
            # a vocabulary-split lookup sums partial rows; a split
            # vocabulary also splits the logits (tied or not)
            vocab = _axes_of(rules.get("vocab"))
            add((b_local, 1 if kind == "decode" else seq, d), "all-reduce",
                vocab, 1)
        if path in (("embed",), ("unembed",)) and (
                path == ("unembed",) or cfg.tie_embeddings):
            vocab = _axes_of(rules.get("vocab"))
            n_logits = 1 + (1 if train and cfg.mtp else 0)
            s_out = seq if train else 1
            # the normalizer's max and sum
            add((b_local, s_out), "all-reduce", vocab, 2 * n_logits,
                torch.float32)
            if train:  # the input gradient of the logits product
                add((b_local, s_out, d), "all-reduce", vocab, n_logits)
            continue
        # biases, norms and constants (the leaves not drawn from a normal)
        # enter no product; tables are looked up; the convolutions are
        # depthwise
        if (len(shape) < 2 or pd.init != "normal"
                or name in ("embed", "pos_embed", "pos", "conv_w")):
            continue
        if axes[-1] == "embed":  # an output projection
            contracted = range(len(shape) - 1)
            out_shape = (shape[-1],)
        elif axes[0] == "embed" or axes[:2] == ("expert", "embed"):
            continue  # column-split: contracts over embed, gathered whole
        else:
            contracted = (0,)
            out_shape = _shard_shape(shape[1:], spec1[1:], mesh)
        split = sorted({a for i in contracted for a in _axes_of(spec1[i])},
                       key=mesh.axis_names.index)
        add((b_local, s_act) + tuple(out_shape), "all-reduce", split,
            reps * (fwd + (1 if train else 0)))
    if kind == "decode":
        attn = (cfg.attn.n_heads, cfg.attn.head_dim) if cfg.attn else None
        mla = (cfg.mla.n_heads, cfg.mla.kv_lora_rank) if cfg.mla else None
        for seg, seg_s in zip(caches, cspecs):
            for b in seg:
                for key, hd in (("k", attn), ("xk", attn), ("c_kv", mla)):
                    if key not in seg[b]:
                        continue
                    t, sp = seg[b][key], seg_s[b][key]
                    bl = _shard_shape(t.shape, sp, mesh)[1]
                    f32, reps = torch.float32, t.shape[0]
                    add((bl, hd[0]), "all-reduce", _axes_of(sp[2]),
                        2 * reps, f32)
                    add((bl,) + hd, "all-reduce", _axes_of(sp[2]), reps,
                        f32)
    return lines


# ------------------------------------------------------------- cell builds


def trace_cell(cfg: ModelConfig, shape_name: str, mesh, *,
               strategy: dict, global_batch: int | None = None) -> dict:
    """Trace one (cfg, shape) step on ``meta`` under the mesh's layout.

    The counterpart of the reference's ``lower_cell``: returns the global
    counts, the memory figures and the collective lines.
    ``global_batch`` overrides the shape's batch (as ``input_specs``'s
    does), e.g. to set a cell beside a run at the batch one card holds."""
    sspec = SHAPES[shape_name]
    kind = sspec.kind
    notes = {}
    if strategy.get("kv_quant"):
        cfg = cfg.replace(kv_quant=True)
    if strategy.get("moe_dispatch_hint") and cfg.moe is not None:
        notes["moe_dispatch_hint"] = "not applied"
    if strategy.get("moe_capacity") and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=strategy["moe_capacity"]))
    dtype = _dtype_of(cfg)
    defs = M.model_defs(cfg)
    rules = build_rules(cfg, mesh, kind, strategy)
    pspecs = partition_specs(defs, rules)
    params = abstract_params(defs, dtype)
    bspec = batch_spec(mesh) if not strategy.get("batch_over_model") else (
        tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names),)
    gb = global_batch if global_batch is not None else sspec.global_batch
    baxes = bspec[0] if bspec else ()
    bsize = _axis_size(mesh, baxes) if baxes else 1
    if gb % bsize != 0:
        bspec, bsize = (), 1  # e.g. long_500k's global_batch=1: replicate
    batch_axis = bspec[0] if bspec else None
    remat = strategy.get("remat", True)

    def data_spec(t):
        return tuple(bspec) + (None,) * (t.dim() - len(bspec))

    specs = input_specs(cfg, shape_name, global_batch=gb)
    caches = cspecs = None
    if kind == "train":
        big = M.param_count(cfg) > 100e9
        ocfg = OptConfig(state_dtype="bfloat16" if big else "float32")
        state = {"params": params, "opt": opt_init(params, ocfg)}
        state_s = {"params": pspecs,
                   "opt": {"m": pspecs, "v": pspecs, "step": ()}}
        step = make_train_step(cfg, ocfg, microbatches=1, remat=remat)
        batch = dict(specs)
        inputs = ((state, state_s),
                  (batch, {k: data_spec(v) for k, v in batch.items()}))
        donated = [(state, state_s)]

        def run():
            return step(state, batch)

        def out_specs(out):
            return (state_s, {k: () for k in out[1]})
    elif kind == "prefill":
        pstep = make_prefill_step(cfg)
        S = specs["tokens"].shape[1]
        extra = cfg.vision.n_patches if cfg.vision is not None else 0
        caches = M.init_cache(cfg, gb, S + extra, dtype, "meta")
        cspecs = cache_pspecs(cfg, caches, mesh, strategy, batch_axis)
        stubs = {k: v for k, v in specs.items()
                 if k in ("enc_frames", "prefix_embeds")}
        data = [specs["tokens"], specs["positions"], *stubs.values()]
        inputs = ((params, pspecs), (caches, cspecs),
                  (data, [data_spec(t) for t in data]))
        donated = [(caches, cspecs)]

        def run():
            return pstep(params, caches, specs["tokens"], specs["positions"],
                         **stubs)

        def out_specs(out):
            return (cspecs, data_spec(out[1]))
    else:
        dstep = make_decode_step(cfg, masked=False)
        caches = M.init_cache(cfg, gb, sspec.seq_len, dtype, "meta")
        cspecs = cache_pspecs(cfg, caches, mesh, strategy, batch_axis)

        def vec(dt):
            return torch.empty((gb,), dtype=dt, device="meta")

        state = {"caches": caches, "length": vec(torch.int32),
                 "last_token": vec(torch.int32), "active": vec(torch.bool)}
        vs = data_spec(state["length"])
        state_s = {"caches": cspecs, "length": vs, "last_token": vs,
                   "active": vs}
        inputs = ((params, pspecs), (state, state_s))
        donated = [(state, state_s)]

        def run():
            return dstep(params, state)

        def out_specs(out):
            return (state_s, vs)

    counter = _TraceCounter()
    with counter:
        out = run()
    live_end = counter.live
    out_leaves = list(_paired(out, out_specs(out)))
    memory = {
        "argument_bytes": sum(_tree_bytes(t, s, mesh) for t, s in inputs),
        "output_bytes": sum(_shard_bytes(t, s, mesh) + 8
                            for t, s in out_leaves),
        "temp_bytes": (counter.peak - live_end) // bsize,
        "alias_bytes": sum(_tree_bytes(t, s, mesh) for t, s in donated),
        "code_bytes": 0,
        "temp_basis": (f"peak live bytes of the meta trace less its outputs, "
                       f"global, / batch split {bsize}"),
    }
    b_local = gb // bsize
    lines = _collective_lines(cfg, kind, mesh, rules, pspecs, dtype, bspec,
                              b_local, sspec.seq_len, remat, caches, cspecs)
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "memory": memory,
        "collective_lines": lines,
        **notes,
    }


def analyze_cell(cfg: ModelConfig, shape_name: str, mesh, *,
                 strategy: dict, variants: bool = True,
                 global_batch: int | None = None) -> dict:
    """The record's analysis fields for one cell (``variants`` has no
    effect: the trace counts every layer)."""
    t0 = time.time()
    tr = trace_cell(cfg, shape_name, mesh, strategy=strategy,
                    global_batch=global_batch)
    n_dev = math.prod(mesh.shape.values())
    text = "\n".join(line for line, c in tr["collective_lines"].items()
                     for _ in range(c))
    coll = collective_traffic(text)
    counts = {"flops": tr["flops"] / n_dev, "bytes": tr["bytes"] / n_dev}
    out = {
        "memory": tr["memory"],
        "scanned": dict(counts),
        "scanned_coll": coll,
        "extrapolated": {
            **counts,
            "coll_total": coll["total"],
            "coll": {k: v for k, v in coll.items()
                     if k not in ("counts", "total")},
            "flops_global": tr["flops"],
            "bytes_global": tr["bytes"],
        },
        "collective_lines": [[line, c] for line, c in
                             tr["collective_lines"].items()],
        "count_basis": (f"meta trace of the global step, every layer "
                        f"unrolled (scanned == extrapolated); flops and "
                        f"bytes per device = global / {n_dev}"),
        "device": "meta",
    }
    if "moe_dispatch_hint" in tr:
        out["moe_dispatch_hint"] = tr["moe_dispatch_hint"]
    out["compile_seconds"] = time.time() - t0
    return out


def model_flops_reference(cfg: ModelConfig, shape_name: str) -> dict:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params."""
    s = SHAPES[shape_name]
    n_active = M.active_param_count(cfg)
    n_total = M.param_count(cfg)
    if s.kind == "train":
        tokens = s.global_batch * s.seq_len
        mf = 6.0 * n_active * tokens
    elif s.kind == "prefill":
        tokens = s.global_batch * s.seq_len
        mf = 2.0 * n_active * tokens
    else:
        tokens = s.global_batch  # one token per request
        mf = 2.0 * n_active * tokens
    return {"model_flops": mf, "active_params": n_active,
            "total_params": n_total, "tokens": tokens}


# --------------------------------------------------------------- the CLI


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             strategy_name: str = "baseline", variants: bool = True,
             out_dir: Path = ARTIFACTS) -> dict:
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape_name)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "strategy": strategy_name, "n_devices": 512 if multi_pod else 256,
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_tag}__{strategy_name}.json"
    if reason is not None:
        rec["skipped"] = reason
        path.write_text(json.dumps(rec, indent=1))
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    strategy = STRATEGIES[strategy_name]
    try:
        res = analyze_cell(cfg, shape_name, mesh, strategy=strategy,
                           variants=variants)
        rec.update(res)
        rec.update(model_flops_reference(cfg, shape_name))
        rec["ok"] = True
    except Exception as e:  # a failure here is a bug in the system
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="baseline",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--no-variants", action="store_true",
                    help="accepted for the reference's interface; the "
                         "trace counts every layer either way")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    for a in archs:
        for s in shapes:
            t0 = time.time()
            rec = run_cell(a, s, multi_pod=args.multi_pod,
                           strategy_name=args.strategy,
                           variants=not args.no_variants,
                           out_dir=Path(args.out))
            status = ("SKIP " + rec.get("skipped", "")) if "skipped" in rec \
                else ("OK" if rec.get("ok") else "FAIL " + rec.get("error", ""))
            print(f"[{time.time()-t0:7.1f}s] {a} x {s} x "
                  f"{'multi' if args.multi_pod else 'single'}: {status}",
                  flush=True)


if __name__ == "__main__":
    main()
