"""Engine step (``serving/steps.py``, ``models/model.py``): device time
launched under the step's cache copies (spans ``step.write_slot``: a leaf
the chunk gave a dtype of its own written back into the slot;
``step.merge``: a masked decode keeping, then putting back, what inactive
rows held at the one written position; ``model.cache_clone``: the copy in
front of the pure entry points, off the engine's path) over all device
time in the trace, in percent."""

from perfbench.attribution import device_share

SPANS = ("step.write_slot", "step.merge", "model.cache_clone")


def read(run):
    return device_share(run.events, SPANS)
