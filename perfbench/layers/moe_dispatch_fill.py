"""Model step (``models/moe.py``): the token copies ``apply_moe`` computed
for the experts held here over the dispatch rows it launched (held
experts x capacity), in percent, from the program's counter
(``repro_torch.telemetry.counters``). The counter adds up only while
``torch.profiler`` runs, so it covers the traced iterations and the
tracer's one warm-up call in set-up (a solo step over every row), and is
read once the window has closed. None for a model without MoE layers and
where the program has no such counter; 0 for a model with MoE layers
whose counter counted nothing, so a counter that never fired reads as
the worst value there is."""


def read(run):
    if not run.cfg["model"].get("moe"):
        return None
    try:
        from repro_torch.telemetry import counters
    except ImportError:
        return None
    tot = counters.moe_totals()
    if tot is None:
        return 0.0
    return 100.0 * tot["kept"] / tot["rows"]
