"""Engine step (``serving/steps.py``, ``models/model.py``): device time
launched under the step's cache copies (spans ``step.write_slot``: the
clone and write of the sub-cache; ``step.merge``: the decode's
``torch.where`` over the caches; ``model.cache_clone``: the per-segment
clone) over all device time in the trace, in percent."""

from perfbench.attribution import device_share

SPANS = ("step.write_slot", "step.merge", "model.cache_clone")


def read(run):
    return device_share(run.events, SPANS)
