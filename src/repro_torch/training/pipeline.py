"""Pipeline-parallel forward (GPipe-style) over a process group.

The reference's ``training/pipeline``, with ranks in place of the mesh's
"pipe" axis: layers are split into ``S`` contiguous stages, one a rank;
microbatches stream through the stages over ``n_micro + S - 1`` ticks
(the GPipe fill/drain loop), each stage idle or forwarding at a tick,
with bubble fraction ``(S-1)/(M+S-1)`` (:func:`bubble_fraction`).  The
reference's ``ppermute`` ring is a ``batch_isend_irecv`` to the next
rank and from the previous one, and its closing ``psum`` an all-reduce
that broadcasts the last stage's outputs to every rank.

The port's pipeline is a forward: ``torch.distributed``'s point-to-point
calls are not differentiable, where the reference differentiates its
``shard_map`` as a whole.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

__all__ = ["bubble_fraction", "make_pipeline_forward"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def make_pipeline_forward(stage_fn: Callable, group=None, *,
                          n_micro: int) -> Callable:
    """stage_fn(stage_params, x, stage_id) -> y, applied per stage.

    Returns ``f(stage_params, xs)``, which every rank of ``group``
    (default: the world; stage s is the group's rank s) calls with its own
    stage's params and the full microbatch stream ``xs`` (leading dim
    n_micro; only stage 0 reads it).  Every rank gets the final stage's
    outputs, same leading dim.  A stage's output has its input's shape.
    """
    S = dist.get_world_size(group)
    ticks = n_micro + S - 1

    def peer(r):
        r %= S
        return r if group is None else dist.get_global_rank(group, r)

    def f(stage_params, xs):
        sid = dist.get_rank(group)
        x0 = xs[0]
        buf = torch.zeros_like(x0)  # inter-stage register
        outs = torch.zeros((n_micro,) + tuple(x0.shape), dtype=x0.dtype,
                           device=x0.device)
        for t in range(ticks):
            mb = t - sid  # the microbatch this stage holds at tick t
            if 0 <= mb < n_micro:
                y = stage_fn(stage_params, xs[t] if sid == 0 else buf, sid)
                if sid == S - 1:
                    outs[mb] = y
            else:  # fill or drain: the stage idles and passes zeros on
                y = torch.zeros_like(x0)
            if S == 1:
                buf = y
                continue
            buf = torch.empty_like(x0)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), peer(sid + 1), group),
                dist.P2POp(dist.irecv, buf, peer(sid - 1), group)])
            for req in reqs:
                req.wait()
        # only the last stage's outs are real; zero-fill + sum broadcasts
        if sid != S - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
        return outs

    return f
