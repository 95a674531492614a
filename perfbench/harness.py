"""One run of one cell, found by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix, and the harness loads
``configs/<config>.json``, ``traffic/<mix>.json``,
``reference/<family>.py`` and, for a ``--trace 1`` run, one reader
``layers/<metric>.py`` per per-layer metric. Nothing here names a cell.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
import types
import typing
from pathlib import Path

import numpy as np

from . import check, stats, traffic
from .driver import serve
from .reference import gate as ref_gate

__all__ = ["load_bench", "load_config", "metric_names", "run_cell",
           "forbidden_modules", "FORBIDDEN"]

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE_TOKENS = 24576  # reference budget: prompt + output tokens compared
SAMPLE_SERVED = 400  # output tokens the sample aims at
TRACE_S = 2.0  # a traced run profiles its window's last seconds
PLAN_RTOL = 1e-6  # the planning LP's contract between two solvers


def load_bench(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str, root: Path = HERE) -> dict:
    with open(root / "configs" / f"{name}.json") as f:
        return json.load(f)


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark's process may not hold."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def metric_names(bench: dict, kind: str, cell: str) -> list:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def _reader(name: str, root: Path):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_layer_{name}", root / "layers" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a per-layer reader sees of a finished run."""

    def __init__(self, rec, cfg, mix, events, peaks):
        self.rec, self.cfg, self.mix = rec, cfg, mix
        self.events, self.peaks = events, peaks


def _model_config(cfg: dict):
    """The configuration's ``model`` block as the port's ``ModelConfig``."""
    from repro_torch.models.config import ModelConfig

    return _from_json(ModelConfig, cfg["model"])


def _from_json(tp, v):
    """``v``, read from JSON, as the port's type ``tp``: a dataclass from an
    object whose keys are its fields, built field by field from the
    dataclass's own type hints; a tuple from a list. An unknown key
    raises."""
    if v is None:
        return None
    if typing.get_origin(tp) in (typing.Union, types.UnionType):  # X | None
        (tp,) = [a for a in typing.get_args(tp) if a is not type(None)]
    if dataclasses.is_dataclass(tp):
        hints = typing.get_type_hints(tp)
        unknown = sorted(set(v) - set(hints))
        if unknown:
            raise ValueError(f"{tp.__name__} has no field {unknown}")
        return tp(**{k: _from_json(hints[k], x) for k, x in v.items()})
    if typing.get_origin(tp) is tuple:  # Tuple[X, ...] or a bare Tuple
        args = typing.get_args(tp)
        return tuple(_from_json(args[0], x) for x in v) if args else tuple(v)
    return v


def _check_layout(mcfg, params):
    """The weights the benchmark drew have the program's parameter tree."""
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import _walk

    want = {p: tuple(d.shape) for p, d in _walk(model_defs(mcfg))}
    got = {p: tuple(t.shape) for p, t in _walk(params)}
    if want != got:
        raise ValueError(f"weights do not match the program's tree: "
                         f"{sorted(set(want.items()) ^ set(got.items()))}")


def _classes(cfg, mix):
    from repro_torch.core.types import WorkloadClass

    means = traffic.class_means(mix, cfg["serving"])
    return [WorkloadClass(c["name"], P, D, mix["rate"] * c["share"],
                          c["patience"])
            for c, (P, D) in zip(mix["classes"], means)]


def _warm(engine, SlotRequest, chunk: int):
    """Serve one request of two chunks and three tokens: every shape the
    window runs (the mixed and the solo step) is built and run once."""
    toks = np.arange(chunk + 1, dtype=np.int32)
    engine.start_prefill(SlotRequest(rid=-1, cls=0, prompt_len=len(toks),
                                     decode_len=3), toks)
    while True:
        res = engine.step()
        if res["prefill_done"] is not None:
            engine.activate_slot(res["prefill_slot"])
        if res["completed"]:
            return


class Cell:
    """A cell set up for serving: its files, the reference family, the
    weights drawn from the seed and the program's configuration."""

    def __init__(self, bench: dict, workload: str, seed: int, device: str,
                 root: Path = HERE, cfg: dict = None, mix: dict = None):
        import torch

        from repro_torch.core.types import Pricing, ServicePrimitives

        self.torch, self.device = torch, device
        spec = next(w for w in bench["workloads"] if w["name"] == workload)
        self.cfg = cfg or load_config(spec["config"], root)
        self.mix = mix or traffic.load_mix(spec["traffic"], root)
        self.family = importlib.import_module(
            f"perfbench.reference.{self.cfg['family']}")
        self.sv = sv = self.cfg["serving"]
        self.params = self.family.make_params(self.cfg, seed, device)
        self.mcfg = _model_config(self.cfg)
        _check_layout(self.mcfg, self.params)
        self.pr = pr = self.cfg["primitives"]
        self.prim = ServicePrimitives(
            alpha=pr["alpha"], beta=pr["beta"], gamma=pr["gamma"],
            batch_cap=sv["batch_cap"], chunk=sv["chunk"])
        self.pricing = Pricing(**self.mix["pricing"])

    def sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def plan(self, rate: float):
        """The classes at ``rate``, the bundled LP's plan and its gate."""
        from repro_torch.core.planning import solve_bundled_lp
        from repro_torch.core.policies import OccupancyGate

        classes = _classes(self.cfg, dict(self.mix, rate=rate))
        plan = solve_bundled_lp(classes, self.prim, self.pricing)
        return classes, plan, OccupancyGate(plan.x, plan.qp)

    def engine(self):
        """A fresh engine over the cell's weights, warmed up."""
        from repro_torch.serving.engine import ServerEngine, SlotRequest

        eng = ServerEngine(self.mcfg, self.params, prim=self.prim,
                           max_len=self.sv["max_len"],
                           dtype=getattr(self.torch, self.sv["cache_dtype"]),
                           device=self.device)
        _warm(eng, SlotRequest, self.sv["chunk"])
        self.sync()
        return eng

    def serve(self, engine, gate, n_classes: int, seed: int, seconds: float,
              rate: float, tracer=None, clock=None):
        """Traffic from now, the window opening ``lead_s`` later and
        lasting ``seconds``; returns the driver's record. ``clock``, for
        tests, is a virtual clock with a ``sleep`` method."""
        from repro_torch.serving.engine import SlotRequest

        lead = float(self.mix["lead_s"])
        reqs = traffic.generate(dict(self.mix, rate=rate), self.sv,
                                self.mcfg.vocab_size, seed, lead + seconds)

        def span(mode):
            from torch.profiler import record_function
            return record_function(f"iteration.{mode}")

        self.sync()
        clk = clock or time.perf_counter
        t0 = clk()
        try:
            rec = serve(
                engine, gate,
                lambda r: SlotRequest(rid=r.rid, cls=r.cls,
                                      prompt_len=r.prompt_len,
                                      decode_len=r.decode_len),
                reqs, chunk=self.sv["chunk"], t0=t0, open_=lead,
                close=lead + seconds, n_classes=n_classes, clock=clk,
                sleep=clock.sleep if clock else time.sleep,
                on_step=tracer.on_step if tracer else None,
                read_lengths=lambda: engine.state["length"].cpu().numpy(),
                span=span if tracer else None)
            self.sync()
        finally:
            if tracer:
                tracer.stop(rec=locals().get("rec"))
        return rec

    def check(self, rec, classes, plan, seed: int):
        """(picked requests, {number: (value, limit)})."""
        picked = check.sample(rec.requests, seed, max_tokens=SAMPLE_TOKENS,
                              min_served=SAMPLE_SERVED)
        limits = self.cfg["check"]["limits"]
        got = {k: float("inf") for k in limits}
        if picked:
            margins = []
            g, _ = check.token_gaps(self.torch, self.family, self.cfg,
                                    self.params, picked, self.device,
                                    margins=margins)
            got = check.gap_numbers(g, check.untied(
                margins, self.cfg["check"]["tie_margin"]))
        x_ref, qp_ref, r_ref = ref_gate.solve_plan(
            [(c.prompt_len, c.decode_len, c.arrival_rate, c.patience)
             for c in classes],
            dict(self.pr, batch_cap=self.sv["batch_cap"],
                 chunk=self.sv["chunk"]),
            self.pricing.c_p, self.pricing.c_d)
        return picked, {
            **{k: (got[k], lim) for k, lim in limits.items()},
            "gate_mismatches": (ref_gate.check_admissions(
                rec.admissions, x_ref, qp_ref), 0),
            "plan_rel_err": (abs(plan.revenue_rate - r_ref) / abs(r_ref),
                             PLAN_RTOL),
        }


def run_cell(bench: dict, workload: str, *, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             root: Path = HERE, cfg: dict = None, mix: dict = None,
             log=None, clock=None) -> dict:
    """Set up, serve the window, read the metrics, check the outputs. A
    ``clock`` (tests) replaces the wall clock in the window."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(bench, workload, seed, device, root, cfg, mix)
    torch = cell.torch
    rate = float(cell.mix["rate"])
    classes, plan, gate = cell.plan(rate)
    engine = cell.engine()
    lead = float(cell.mix["lead_s"])
    tracer = None
    if trace:
        from .tracing import Tracer
        tracer = Tracer(torch, lead + seconds - TRACE_S)
        tracer.warm(engine.step)
    t_traffic = time.perf_counter()
    rec = cell.serve(engine, gate, len(classes), seed, seconds, rate,
                     tracer, clock)
    setup_s = t_traffic + lead - t_start
    late = [float(np.percentile(rec.lateness, q)) * 1e3
            for q in (50, 95, 100)] if rec.lateness else [0.0] * 3
    log(f"[perfbench] {workload} seed {seed}: {len(rec.requests)} requests "
        f"generated, {len(rec.lateness)} released; generator lateness ms "
        f"p50 {late[0]!r} p95 {late[1]!r} max {late[2]!r}")
    log(f"[perfbench] {_step_note(rec)}")
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    dev_name = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- metrics
    out_metrics, extra = {}, {}
    if not trace:
        e2e = {
            "setup_s": setup_s,
            "ttft_p95_ms": _ms(stats.p95(stats.ttft(rec))),
            "tpot_p95_ms": _ms(stats.p95(stats.tpot_gaps(rec))),
            "revenue_per_s": stats.revenue_per_s(rec, cell.pricing.c_p,
                                                 cell.pricing.c_d),
        }
        for m in metric_names(bench, "end_to_end", workload):
            if e2e.get(m["name"]) is not None:
                out_metrics[m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
    else:
        from .roofline.peaks import peaks
        from .tracing import breakdown, union

        ev = tracer.events
        run = Run(rec, cell.cfg, cell.mix, ev, peaks(dev_name))
        for m in metric_names(bench, "per_layer", workload):
            v = _reader(m["name"], root)(run)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": union((a, b) for _, a, b in ev["kernels"]) / 1e6,
                 "window_s": tracer.wall}

    # ---- correctness, once the program's state is freed
    picked, checks = cell.check(rec, classes, plan, seed)
    correct = bool(picked) and all(v <= lim for v, lim in checks.values())
    log(f"[perfbench] checked {len(picked)} finished requests, "
        f"{sum(r.decode_len for r in picked)} served tokens, "
        f"{sum(r.prompt_len + r.decode_len for r in picked)} tokens in all")
    res = {"correct": correct, "attempted": len(stats.in_window(rec)),
           "failed": 0, "metrics": out_metrics,
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": dev_name, "count": 1,
                      "memory_peak_bytes": peak, **extra}}
    if trace:
        res["breakdown"] = breakdown(tracer.events)
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return res


def _ms(v):
    return None if v is None else 1e3 * v


def _step_note(rec) -> str:
    """The window's iterations by mode: how many, and the time from the
    previous iteration's end to this one's (a token gap), p50 / p95 / max
    in ms; the spread of ``tpot_p95_ms`` is read against it."""
    its = rec.iterations
    parts = []
    for mode in ("mixed", "solo"):
        gaps = [1e3 * (b.t1 - a.t1) for a, b in zip(its, its[1:])
                if b.mode == mode and rec.open <= b.t1 < rec.close]
        q = np.percentile(gaps, (50, 95, 100)).tolist() if gaps else []
        parts.append(f"{mode} {len(gaps)} gap ms {q!r}")
    return "window steps: " + "; ".join(parts)
