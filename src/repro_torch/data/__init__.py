from .traces import Request, TraceConfig, load_trace_csv, synth_azure_trace  # noqa: F401
