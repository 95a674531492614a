"""Device: the share of the traced iterations' host spans (the
``iteration.mixed`` / ``iteration.solo`` ranges around each engine step)
in which no kernel runs, in percent."""

from perfbench.tracing import busy_in


def read(run):
    ranges = [(a, b) for _, a, b in run.events["ranges"]]
    span = sum(b - a for a, b in ranges)
    if not ranges or span <= 0:
        return None
    busy = busy_in([(a, b) for _, a, b in run.events["kernels"]], ranges)
    return 100.0 * (1.0 - busy / span)
