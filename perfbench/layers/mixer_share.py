"""Model step (``models/attention.py`` and the other mixers): device time
launched under the span ``model.mixer`` (the token mixer in
``_apply_block``) over all device time in the trace, in percent."""

from perfbench.attribution import device_share


def read(run):
    return device_share(run.events, ("model.mixer",))
