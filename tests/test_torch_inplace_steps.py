"""The serving engine's steps, which write the caches the engine owns in
place, held bit for bit on the CPU to the copy-on-write steps written
plainly here (the chunk into a copy of the slot's caches, that written
into a copy of the caches, the decode into another copy and a merge over
the whole caches), which share none of the engine's masking.

Each reduced config is served through ``ServerEngine`` with its steps
wrapped: before every engine step the copy-on-write step runs on the same
state, and every cache leaf, ``length``, ``last_token``, ``active`` and
token must agree, while the engine's cache leaves keep their storage. The run
has slots prefilling, decoding, free and finished at once, a ring cache
that wraps (gemma2, recurrentgemma), int8 KV and MLA latents, recurrent
states, the stub inputs (paligemma's patches, whisper's frames; whisper
with f32 weights over bf16 caches, so its cross-attention K/V go back
into the slot in the cache's dtype)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import ServicePrimitives
from repro_torch.models import model as M
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.serving.engine import ServerEngine, SlotRequest
from repro_torch.serving.steps import greedy_sample
from test_torch_gpu import _stubs

B, C, MAX_LEN = 4, 8, 64
CASES = [("qwen2-0.5b", {}), ("qwen2-0.5b", {"kv_quant": True}),
         ("gemma2-2b", {}), ("deepseek-v3-671b", {}), ("mamba2-130m", {}),
         ("recurrentgemma-2b", {}), ("whisper-base", {}),
         ("paligemma-3b", {})]


def _leaves(state):
    return [a for _, a in tree_flatten(state["caches"])]


def _same(got, want):
    assert got.dtype == want.dtype and torch.equal(got, want)


def _cow_decode(cfg):
    """The masked decode step as copy-on-write: a decode into a copy of
    the caches, then inactive rows take the old caches back whole."""
    def step(params, state):
        act = state["active"]
        logits, new = M.forward_decode(cfg, params,
                                       state["last_token"][:, None],
                                       state["length"],
                                       tree_map(torch.clone, state["caches"]))
        nxt = greedy_sample(logits)
        caches = tree_map(lambda n, o: torch.where(
            act.reshape((1, -1) + (1,) * (n.dim() - 2)), n, o),
            new, state["caches"])
        return {"caches": caches,
                "length": state["length"] + act.to(torch.int32),
                "last_token": torch.where(act, nxt, state["last_token"]),
                "active": act}, nxt
    return step


def _cow_mixed(cfg, chunk):
    """The mixed step as copy-on-write: the chunk into a copy of the
    slot's caches, written into a copy of the caches, then the decode."""
    dec = _cow_decode(cfg)

    def step(params, state, p_slot, tokens, pos0, kv_len=None, **stubs):
        sub = tree_map(lambda a: a[:, p_slot:p_slot + 1].clone(),
                       state["caches"])
        positions = pos0 + torch.arange(chunk, dtype=torch.int32)[None]
        logits, sub = M.forward_prefill(cfg, params, tokens[None], positions,
                                        sub, continuation=True,
                                        kv_len=kv_len, **stubs)

        def put(a, s):
            a = a.clone()
            a[:, p_slot:p_slot + 1] = s
            return a

        act = state["active"]
        keep = torch.arange(act.shape[0]) != p_slot
        out, toks = dec(params, dict(
            state, caches=tree_map(put, state["caches"], sub),
            active=act & keep))
        return dict(out, active=act), toks, greedy_sample(logits)[0]
    return step


def _lockstep(cow, step, ptrs, count, **stubs):
    """``step`` in the engine's place, checked against ``cow`` run first
    on the same state."""
    def run(params, state, *args, **kw):
        want = cow(params, state, *args, **kw, **stubs)
        got = step(params, state, *args, **kw, **stubs)
        g_leaves = _leaves(got[0])
        assert len(g_leaves) == len(ptrs)
        for g, w in zip(got[1:], want[1:]):
            _same(g, w)
        w_leaves = _leaves(want[0])
        assert len(w_leaves) == len(g_leaves)
        for g, w in zip(g_leaves, w_leaves):
            _same(g, w)
        for k in ("length", "last_token", "active"):
            _same(got[0][k], want[0][k])
        assert [a.data_ptr() for a in g_leaves] == ptrs
        count.append(len(args))
        return got
    return run


@pytest.mark.parametrize("arch,over", CASES, ids=[
    a + ("-kv_quant" if o else "") for a, o in CASES])
def test_engine_steps_in_place_match_the_pure_steps(arch, over):
    cfg = get_config(arch, reduced=True).replace(**over)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    dtype = torch.bfloat16 if cfg.encoder is not None else torch.float32
    eng = ServerEngine(cfg, params, prim=ServicePrimitives(batch_cap=B,
                                                           chunk=C),
                       max_len=MAX_LEN, dtype=dtype, device="cpu")
    rng = np.random.default_rng(7)
    stubs = {k: torch.from_numpy(v) for k, v in _stubs(cfg, 1, rng).items()}
    ptrs = [a.data_ptr() for a in _leaves(eng.state)]
    steps = []
    eng._decode = _lockstep(_cow_decode(cfg), eng._decode, ptrs, steps)
    eng._mixed = _lockstep(_cow_mixed(cfg, C), eng._mixed, ptrs, steps,
                           **stubs)

    def serve(rid, n, decode_len):
        req = SlotRequest(rid, 0, n, decode_len)
        eng.start_prefill(req, rng.integers(2, cfg.vocab_size, n))
        while True:
            res = eng.step()
            if res["prefill_done"] is not None:
                eng.activate_slot(res["prefill_slot"])
                return req

    a = serve(0, 11, 40)           # slot 0, decoding to the end
    b = serve(1, 9, 3)             # slot 1, finishes in c's third chunk
    c = serve(2, 37, 3)            # slot 2: the ring (window 32) wraps
    assert b.tokens_out == 3 and eng.slots[1] is None
    assert eng.state["active"].tolist() == [True, False, True, False]
    while eng.slots[2] is not None:
        eng.step()
    assert c.tokens_out == 3 and a.tokens_out == 10
    # 2 + 2 + 5 mixed steps (slot, chunk, start), then 3 solo steps
    assert steps == [3] * 9 + [0] * 3
