"""The one traffic generator: every mix is a data file under ``traffic/``.

A mix file gives its classes (share, lognormal prompt and output laws), its
arrival process (``poisson`` or ``mmpp``), the offered rate, the lead
before the window and a ``base_seed``. The base seed fixes the arrival
times and the sizes; the run's seed draws the prompt tokens and shuffles
the sizes inside consecutive blocks of ``shuffle_block`` arrivals (1:
not at all), so every seed serves the same work. Where the order of the
sizes sets a tail (a queue below the knee), a mix keeps it.

The samplers are copies of the program's own (``data/traces.py``'s
``sample_lengths``, ``workloads/arrivals.py``'s Poisson and MMPP), held to
them by ``test_perfbench_traffic.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["Request", "load_mix", "lognormal", "sample_lengths",
           "poisson_arrivals", "mmpp_arrivals", "generate", "class_means"]

HERE = Path(__file__).resolve().parent


@dataclass
class Request:
    """One request of the stream, and what happened to it."""

    rid: int
    cls: int
    due: float  # seconds after the traffic starts
    prompt: np.ndarray  # int32 token ids
    decode_len: int
    released: float = float("nan")  # when the driver queued it
    admitted: float = float("nan")  # start_prefill
    prefilled: float = float("nan")  # its last chunk ran
    token_times: list = field(default_factory=list)
    out_tokens: list = field(default_factory=list)
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def load_mix(name: str, root: Path = HERE) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def lognormal(rng, mean, cv, size=None):
    sigma2 = np.log(1 + cv * cv)
    mu = np.log(mean) - sigma2 / 2
    return rng.lognormal(mu, np.sqrt(sigma2), size=size)


def sample_lengths(rng, mean_prompt, cv_prompt, mean_decode, cv_decode):
    """One (P, D) pair, floored at 8 prompt and 2 output tokens."""
    P = max(8, int(lognormal(rng, mean_prompt, cv_prompt)))
    D = max(2, int(lognormal(rng, mean_decode, cv_decode)))
    return P, D


def poisson_arrivals(rng, rate, horizon):
    out = []
    t = 0.0
    chunk = max(16, int(rate * horizon * 1.2) + 16)
    while t < horizon:
        gaps = rng.exponential(1.0 / rate, size=chunk)
        ts = t + np.cumsum(gaps)
        out.append(ts[ts < horizon])
        t = float(ts[-1])
    return np.concatenate(out) if out else np.empty(0)


def mmpp_arrivals(rng, base_rate, levels, switch, horizon):
    """Cyclic k-regime MMPP: rate ``base_rate * levels[j]`` in regime j,
    left at rate ``switch[j]``."""
    out = []
    t, j = 0.0, 0
    t_switch = rng.exponential(1.0 / switch[j])
    while t < horizon:
        rate = base_rate * levels[j]
        if rate <= 0:
            t = t_switch
            j = (j + 1) % len(levels)
            t_switch = t + rng.exponential(1.0 / switch[j])
            continue
        dt = rng.exponential(1.0 / rate)
        if t + dt > t_switch:
            t = t_switch
            j = (j + 1) % len(levels)
            t_switch = t + rng.exponential(1.0 / switch[j])
            continue
        t += dt
        if t < horizon:
            out.append(t)
    return np.asarray(out)


def _arrivals(mix: dict, rng, horizon: float):
    arr = mix["arrivals"]
    if arr["process"] == "poisson":
        return poisson_arrivals(rng, mix["rate"], horizon)
    if arr["process"] == "mmpp":
        levels = np.asarray(arr["levels"], float)
        switch = np.asarray(arr["switch"], float)
        # stationary regime shares of the cycle: time in j ~ 1/switch[j]
        occ = (1.0 / switch) / (1.0 / switch).sum()
        base = mix["rate"] / float(occ @ levels)  # time-average = rate
        return mmpp_arrivals(rng, base, tuple(levels), tuple(switch), horizon)
    raise ValueError(f"unknown arrival process {arr['process']!r}")


def _sizes(mix: dict, rng, n: int, max_prompt: int, max_output: int):
    shares = np.array([c["share"] for c in mix["classes"]], float)
    shares /= shares.sum()
    out = []
    for _ in range(n):
        i = int(rng.choice(len(shares), p=shares))
        c = mix["classes"][i]
        P, D = sample_lengths(rng, c["prompt"]["mean"], c["prompt"]["cv"],
                              c["output"]["mean"], c["output"]["cv"])
        out.append((i, min(P, max_prompt), min(D, max_output)))
    return out


def generate(mix: dict, serving: dict, vocab: int, seed: int,
             horizon: float) -> list[Request]:
    """Requests due on ``[0, horizon)`` seconds after the traffic starts."""
    base = np.random.default_rng(int(mix["base_seed"]))
    due = _arrivals(mix, base, horizon)
    sizes = _sizes(mix, base, len(due), serving["max_prompt"],
                   serving["max_output"])
    rng = np.random.default_rng(int(seed))
    blk = int(mix["shuffle_block"])
    order = np.concatenate([s + rng.permutation(min(blk, len(due) - s))
                            for s in range(0, len(due), blk)]) \
        if len(due) else np.empty(0, int)
    reqs = []
    for rid, (t, k) in enumerate(zip(due, order)):
        cls, P, D = sizes[int(k)]
        toks = rng.integers(0, vocab, size=P, dtype=np.int32)
        reqs.append(Request(rid, cls, float(t), toks, D))
    return reqs


def class_means(mix: dict, serving: dict, horizon: float = 600.0):
    """Per class (mean P, mean D) of the mix's fixed size set, clipped as
    served, over ``horizon`` seconds of its arrivals: the planner's
    class lengths."""
    base = np.random.default_rng(int(mix["base_seed"]))
    due = _arrivals(mix, base, horizon)
    sizes = _sizes(mix, base, len(due), serving["max_prompt"],
                   serving["max_output"])
    out = []
    for i in range(len(mix["classes"])):
        s = [(P, D) for c, P, D in sizes if c == i]
        out.append((float(np.mean([p for p, _ in s])),
                    float(np.mean([d for _, d in s]))))
    return out
