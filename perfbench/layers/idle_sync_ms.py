"""Device: kernel-free time between the device events launched in the
traced iterations while the host, at the gap's midpoint on its own clock,
is anywhere but a launching phase: in ``step.sync`` (the decode's reads),
``step.account``, the rest of ``engine.step`` or the serving loop between
steps; per traced iteration, in ms. With ``idle_launch_ms``, all of that
stretch's idle time; all of it alone where the trace holds no program
span."""

from perfbench.attribution import idle_split


def read(run):
    s = idle_split(run.events)
    return None if s is None else s[1] / 1e3 / s[2]
