"""Model step (``models/moe.py``): device time launched under the span
``model.moe`` (``apply_moe`` in ``_apply_block``) over all device time
in the trace, in percent."""

from perfbench.attribution import device_share


def read(run):
    return device_share(run.events, ("model.moe",))
