"""Model step (``models/``): the model FLOPs of the window's untraced
iterations (``roofline/model.py``: served tokens through the weights they
touch, attention over their real context) over those iterations' host
wall times the card's bf16 peak, in percent. None for a model the
roofline cannot count."""

from perfbench.roofline.model import countable, iteration_flops


def read(run):
    if run.peaks is None or not countable(run.cfg["model"]):
        return None
    rec = run.rec
    lo, hi = rec.traced or (-1, -2)
    its = [it for k, it in enumerate(rec.iterations)
           if rec.open <= it.t0 < rec.close and not lo <= k <= hi]
    wall = sum(it.t1 - it.t0 for it in its)
    if not its or wall <= 0:
        return None
    flops = sum(iteration_flops(run.cfg["model"], it.decode_ctx, it.chunk)
                for it in its)
    return 100.0 * flops / (wall * run.peaks["bf16_flops"])
