"""Admission (``core/policies.py``'s gate and the driver's class queues):
95th percentile, over requests due in the window, of due to
``start_prefill``; one still queued at the close counts its wait so far."""

from perfbench import stats


def read(run):
    v = stats.p95(stats.queue_wait(run.rec))
    return None if v is None else 1e3 * v
