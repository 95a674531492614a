"""Engine step (``serving/engine.py``, ``serving/steps.py``): the
window's mixed iterations' host wall over their count, leaving out the
traced ones (the profiler slows them)."""

from perfbench import stats


def read(run):
    v = stats.tau(run.rec, "mixed", skip=run.rec.traced)
    return None if v is None else 1e3 * v
