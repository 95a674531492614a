"""Why ``mamba2-130m`` has no cell: the engine's chunked prefill of a
state-space model serves other tokens than the model.

For each seed, one request goes through ``ServerEngine`` (prefill in
chunks of C, then greedy decodes) and, on the same weights, through two
other paths of the program that agree with each other: the whole prompt
in one ``forward_prefill`` and the prompt fed one token at a time through
``forward_decode`` (the recurrence), each followed by the same greedy
decodes, all in float32. The engine pads a prompt's last chunk with
token 0 and scans the padding into the state, and each chunk restarts
the SSM state from zero (ROADMAP C-ref4), so its tokens part from the
other two.

    PYTHONPATH=src python3 perfbench/witness_ssm.py --seeds 1,2,3 \
        --prompt 61 --chunk 512 [--device cuda]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _greedy(torch, M, cfg, params, caches, logits, start, n):
    out, tok = [], int(logits[0, -1].argmax())
    for k in range(n):
        out.append(tok)
        pos = torch.tensor([start + k], dtype=torch.int32,
                           device=logits.device)
        logits, caches = M.forward_decode(
            cfg, params, torch.tensor([[tok]], dtype=torch.int32,
                                      device=logits.device), pos, caches)
        tok = int(logits[0, -1].argmax())
    return out


def paths(seed: int, P: int, C: int, D: int, device: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import ServicePrimitives
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServerEngine, SlotRequest

    # float32 activations, so rounding cannot part the paths
    cfg = get_config("mamba2-130m").replace(param_dtype="float32")
    params = M.init_model(cfg, torch.Generator(device=device)
                          .manual_seed(seed), device=device)
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (P,), generator=g,
                           dtype=torch.int32)
    max_len = -(-P // C) * C + D + 1

    # the engine: chunks of C, the last one padded; it decodes from the
    # prompt's last token at position P
    eng = ServerEngine(cfg, params, prim=ServicePrimitives(batch_cap=2,
                                                           chunk=C),
                       max_len=max_len, dtype=torch.float32, device=device)
    req = SlotRequest(rid=0, cls=0, prompt_len=P, decode_len=D)
    eng.start_prefill(req, prompt.numpy())
    while req.tokens_out < D:
        res = eng.step()
        if res["prefill_done"] is not None:
            eng.activate_slot(res["prefill_slot"])
    served = list(req.out_tokens)

    # the same sequence the engine feeds: prompt, prompt[-1], outputs
    seq = torch.cat([prompt, prompt[-1:]]).to(device)
    whole_logits, caches = M.forward_prefill(
        cfg, params, seq[None, :P], torch.arange(P, device=device)[None],
        M.init_cache(cfg, 1, max_len, torch.float32, device))
    logits, caches = M.forward_decode(cfg, params, seq[None, P:P + 1],
                                      torch.tensor([P], device=device),
                                      caches)
    whole = _greedy(torch, M, cfg, params, caches, logits, P + 1, D)

    caches = M.init_cache(cfg, 1, max_len, torch.float32, device)
    for t in range(P + 1):
        logits, caches = M.forward_decode(cfg, params, seq[None, t:t + 1],
                                          torch.tensor([t], device=device),
                                          caches)
    step = _greedy(torch, M, cfg, params, caches, logits, P + 1, D)
    return served, whole, step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--prompt", type=int, default=61)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        served, whole, step = paths(seed, args.prompt, args.chunk,
                                    args.decode, args.device)
        agree = sum(a == b for a, b in zip(served, step))
        print(f"seed {seed} P={args.prompt} C={args.chunk}: engine "
              f"{served}\n  whole prompt {whole}\n  recurrence   {step}\n"
              f"  whole == recurrence: {whole == step}; engine agrees with "
              f"the recurrence on {agree} of {len(step)} tokens", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
