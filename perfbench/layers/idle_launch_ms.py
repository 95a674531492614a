"""Device: kernel-free time between the device events launched in the
traced iterations while the host, at the gap's midpoint on its own clock,
is inside ``step.chunk``, ``step.write_slot``, ``step.decode`` or
``step.merge`` (launching the step's work); per traced iteration, in ms.
``attribution.idle_split`` places each gap on the host's clock by the
launch that ends it."""

from perfbench.attribution import idle_split


def read(run):
    s = idle_split(run.events)
    return None if s is None else s[0] / 1e3 / s[2]
