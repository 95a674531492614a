"""Observability of the port (the reference's ``repro.telemetry``).

* :mod:`repro_torch.telemetry.probes` -- fixed-shape state probes
  threaded through the engines' carries, the pure-Python
  :class:`PyProbes` twin and the host-side :func:`extract_probes`.
* :mod:`repro_torch.telemetry.trace` -- Chrome-trace/Perfetto
  ``trace_event`` JSON export of request lifecycles and replan epochs.
* :mod:`repro_torch.telemetry.manifest` -- schema-versioned ``RunRecord``
  JSONL provenance (torch, CUDA and the card in place of the
  reference's JAX version).
* :mod:`repro_torch.telemetry.timing` -- the host and CUDA timers.
* :mod:`repro_torch.telemetry.spans` -- ``span(name, **attrs)`` around
  the phases of ``ServerEngine.step`` and of the model: ``cpu_op`` ranges
  while ``torch.profiler`` runs, one flag check otherwise.
* :mod:`repro_torch.telemetry.counters` -- totals added up on the card
  under the same gate (the MoE's dispatch: copies kept, dropped, rows
  launched), read once after a traced window.

An operator records a window of spans, with the device's kernels beside
them, and writes it as a Chrome trace::

    from torch.profiler import profile

    with profile(record_shapes=True) as prof:
        for _ in range(100):
            engine.step()
    prof.export_chrome_trace("steps.json")

The spans show as ``cpu_op`` events whose ``args`` hold their attrs
(``engine.step``: ``mode``, ``decoding``, ``chunk_tokens``;
``step.merge``: ``bytes``).

``python -m repro_torch.telemetry`` renders trajectory/SLI reports and
validates emitted trace/manifest files.
"""

from .manifest import (MANIFEST_SCHEMA_VERSION, append_record,
                       default_manifest_path, payload_digest, read_records,
                       run_record, validate_record)
from .probes import (PROBES, ProbeSpec, PyProbes, extract_probes,
                     hist_attainment, hist_edges, hist_percentile,
                     resolve_probe_spec)
from .spans import span
from .timing import timeit_median
from .trace import (TRACE_SCHEMA_VERSION, lifecycle_events, replan_events,
                    trace_payload, validate_trace, write_trace)

__all__ = [
    "MANIFEST_SCHEMA_VERSION",
    "PROBES",
    "ProbeSpec",
    "PyProbes",
    "TRACE_SCHEMA_VERSION",
    "append_record",
    "default_manifest_path",
    "extract_probes",
    "hist_attainment",
    "hist_edges",
    "hist_percentile",
    "lifecycle_events",
    "payload_digest",
    "read_records",
    "replan_events",
    "resolve_probe_spec",
    "run_record",
    "span",
    "timeit_median",
    "trace_payload",
    "validate_record",
    "validate_trace",
    "write_trace",
]
