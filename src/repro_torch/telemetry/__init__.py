"""Host-side observability: probes for the Python engine and the shared
timing helper.  Trace export and run manifests are ROADMAP A1/A8."""

from .probes import (PROBES, ProbeSpec, PyProbes, extract_probes,
                     hist_attainment, hist_edges, hist_percentile,
                     resolve_probe_spec)
from .timing import timeit_median

__all__ = [
    "PROBES",
    "ProbeSpec",
    "PyProbes",
    "extract_probes",
    "hist_attainment",
    "hist_edges",
    "hist_percentile",
    "resolve_probe_spec",
    "timeit_median",
]
