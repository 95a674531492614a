"""Per-layer metric readers, one file per metric, named as the metric.

Each defines ``read(run) -> float | None`` over a finished ``--trace 1``
run (``harness.Run``: the driver's record, the cell's configuration and
mix, the traced slice's events and the card's peaks). A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""
