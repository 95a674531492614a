"""What decides ``correct``: the served tokens against the plain reference,
and the gate's admissions against a plan the reference solves again.

Served tokens. Once the window has closed and the program's state is
freed, a sample of the finished requests, drawn from the seed with the
longest among them, is run through the reference once: each prompt
followed by its served tokens. The engine feeds a prompt's last token
again at position P after the prefill, so output token j is the argmax
of the logits at position P + j over the sequence prompt, prompt[-1],
out[0], ..., out[D - 2]. The number compared is the widest gap by which
a served token's reference logit lies below the reference's best at its
position.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample", "sequences", "token_gaps", "gap_numbers"]


def sample(requests, seed: int, *, max_tokens: int, min_served: int):
    """Finished requests: the longest (prompt + output), then others in
    an order drawn from ``seed``, until ``min_served`` output tokens are
    in or the next would pass ``max_tokens`` in all."""
    done = [r for r in requests if r.done]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.decode_len, r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 1]).permutation(len(rest))
    out, tot, served = [longest], longest.prompt_len + longest.decode_len, \
        longest.decode_len
    for k in order:
        r = rest[int(k)]
        n = r.prompt_len + r.decode_len
        if served >= min_served or tot + n > max_tokens:
            break
        out.append(r)
        tot += n
        served += r.decode_len
    return out


def sequences(torch, reqs, device):
    """(token sequences, positions whose logits the served tokens are)."""
    seqs, want = [], []
    for r in reqs:
        out = np.asarray(r.out_tokens, np.int64)
        s = np.concatenate([r.prompt, r.prompt[-1:], out[:-1]])
        seqs.append(torch.as_tensor(s, device=device))
        want.append(np.arange(r.prompt_len, r.prompt_len + len(out)))
    return seqs, want


def token_gaps(torch, family, cfg, params, reqs, device, *,
               control: bool = False, margins=None):
    """Per served position, how far below the reference's best logit lies
    the served token, and (``control=True``) the token that the reference
    computed in fp8 puts first: the correctness control, read at the same
    positions of the same sequences. Returns (served, control or None).
    ``margins``, if a list, gets the reference's router margins at those
    positions, one array a layer."""
    seqs, want = sequences(torch, reqs, device)
    mg = [] if margins is not None else None
    ref = family.served_logits(cfg, params, seqs, want, margins=mg)
    low = (family.served_logits(cfg, params, seqs, want, precision="fp8")
           if control else [None] * len(reqs))
    served, ctrl = [], []
    for r, a, b in zip(reqs, ref, low):
        best = a.max(-1).values
        tok = torch.as_tensor(np.asarray(r.out_tokens, np.int64),
                              device=a.device)
        served.append((best - a.gather(1, tok[:, None])[:, 0]).cpu().numpy())
        if control:
            ctrl.append((best - a.gather(1, b.argmax(-1)[:, None])[:, 0])
                        .cpu().numpy())
    if margins is not None:
        starts = np.cumsum([0] + [len(s) for s in seqs])
        rows = np.concatenate([w + s0 for w, s0 in zip(want, starts)])
        margins.extend(m.cpu().numpy()[rows] for m in mg)
    return (np.concatenate(served),
            np.concatenate(ctrl) if control else None)


def untied(margins, tie: float):
    """Positions whose routing the reference finds clear of a tie: in
    every layer the router's k-th logit passes the next by ``tie`` or
    more. Nearer a tie, rounding in any precision picks the experts."""
    return np.min(np.stack(margins), axis=0) >= tie


def gap_numbers(g, keep) -> dict:
    """What the gaps of one run's checked tokens are compared by."""
    return {"widest_gap_untied": float(g[keep].max()) if keep.any()
            else float("inf")}
