"""Device time and device idle time by the program's own spans.

The port marks the phases of its serving step and model with spans
(``repro_torch.telemetry.spans``): ``cpu_op`` events named ``engine.*``,
``step.*`` and ``model.*`` among a traced run's host events. Each device
event is paired with the host runtime call that started it, in order:
the engine runs on one stream, so the n-th launch starts the n-th device
event. A device event belongs to the innermost span that holds its
launch, by the span's own interval. Without kineto's correlation ids the
order is all there is: a step replayed from a CUDA graph (one
``cudaGraphLaunch``, many kernels) does not pair, and every reader here
reads None.

Only host times are compared with the spans. On an H100 the profiler's
device timestamps drift from its host timestamps within a 2 s window
(by up to 79 ms, the device clock running 8% fast for part of it), so a
device time read against a host span can land in another step. A device
idle gap is placed on the host's clock by the launch that ends it: the
device, idle, starts that event as soon as it is launched, so the gap
is the host time just before that launch. Works on ``run.events``
alone.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "LAUNCH_SPANS", "program_spans", "paired",
           "launched_under", "device_share", "idle_split"]

LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
NOT_LAUNCHES = ("cudaLaunchHostFunc", "cuLaunchHostFunc")  # no device event
SPAN_PREFIXES = ("engine.", "step.", "model.")
# phases in which the host is launching the step's work
LAUNCH_SPANS = frozenset({"step.chunk", "step.write_slot", "step.decode",
                          "step.merge"})


def program_spans(events: dict) -> list:
    """The program's spans, by start (an enclosing span before a child
    that starts with it)."""
    return sorted((h for h in events["host"]
                   if h[0].startswith(SPAN_PREFIXES)),
                  key=lambda h: (h[1], -h[2]))


def _chains(spans: list, times) -> list:
    """For each of the ascending ``times``, the names of the spans that
    hold it, outermost first (spans nest, as one thread's do)."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] < spans[j][2]:  # not around it
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(tuple(s[0] for s in stack))
    return out


def _kind(name: str) -> str:
    if name.startswith(("cudaMemcpy", "Memcpy")):
        return "copy"
    if name.startswith(("cudaMemset", "Memset")):
        return "set"
    return "kernel"


def paired(events: dict):
    """[(device event, its launch)] in device order, or None where they
    do not pair. Paired from the last back: the tracer synchronises
    before it stops, so every launch has run and been recorded by then,
    while the profiler can miss the device side of the first launches
    after it starts (five, on an H100, all within the first traced
    iteration). So launches may go unpaired only there. Each pair has to
    be of one kind (a copy, a set or a kernel), and each device event's
    name has to come from one runtime call throughout: a device event
    lost later on shifts the pairs before it onto their neighbours'
    launches, which breaks both."""
    launches = sorted((h for h in events["host"]
                       if h[0].startswith(LAUNCHES)
                       and not h[0].startswith(NOT_LAUNCHES)),
                      key=lambda h: h[1])
    kernels, ranges = events["kernels"], events["ranges"]
    lost = len(launches) - len(kernels)
    if lost < 0 or lost and not (ranges and
                                 launches[lost - 1][1] < ranges[0][2]):
        return None
    pairs = list(zip(kernels, launches[lost:]))
    call = {}
    for k, h in pairs:
        if _kind(k[0]) != _kind(h[0]) or call.setdefault(k[0], h[0]) != h[0]:
            return None
    return pairs


def launched_under(events: dict):
    """[(device event, names of the spans holding its launch, outermost
    first)]; [] when the trace holds no program span, None when launches
    and device events do not pair."""
    spans = program_spans(events)
    if not spans:
        return []
    pairs = paired(events)
    if pairs is None:
        return None
    return [(k, chain) for (k, _), chain
            in zip(pairs, _chains(spans, [h[1] for _, h in pairs]))]


def device_share(events: dict, names) -> float | None:
    """Device time launched with one of ``names`` the innermost span, over
    all device time in the trace, in percent: 0.0 with no program span
    (no device time was launched under one), None where launches do not
    pair."""
    pairs = launched_under(events)
    if pairs is None:
        return None
    total = sum(b - a for _, a, b in events["kernels"])
    if not pairs or total <= 0:
        return 0.0
    mine = sum(k[2] - k[1] for k, chain in pairs
               if chain and chain[-1] in names)
    return 100.0 * mine / total


def _gaps(kernels) -> list:
    """(index of the device event that ends each kernel-free gap between
    ``kernels`` (in start order), the gap's length)."""
    gaps, end = [], kernels[0][2] if kernels else 0.0
    for i, (_, a, b) in enumerate(kernels[1:], 1):
        if a > end:
            gaps.append((i, a - end))
        end = max(end, b)
    return gaps


def idle_split(events: dict):
    """(launch, sync, iterations): the device's kernel-free time between
    the first and the last device event launched in the traced
    iterations, in the trace's microseconds, by what the host was doing
    at each gap's midpoint on its own clock (the gap's length before the
    launch that ends it). Launch: inside one of ``LAUNCH_SPANS`` or a
    child of one; sync: anywhere else (``step.sync``, ``step.account``,
    the rest of ``engine.step``, the serving loop). With no program span
    no gap can fall inside a launching phase: (0.0, the kernel-free time
    between the device events that start inside the iteration ranges'
    span, n). None without iteration ranges or where launches do not
    pair."""
    ranges = events["ranges"]
    if not ranges:
        return None
    w0, w1 = ranges[0][1], max(b for _, _, b in ranges)
    spans = program_spans(events)
    if not spans:
        inside = [k for k in events["kernels"] if w0 <= k[1] <= w1]
        return 0.0, sum(g for _, g in _gaps(inside)), len(ranges)
    pairs = paired(events)
    if pairs is None:
        return None
    window = [(k, h) for k, h in pairs if w0 <= h[1] <= w1]
    # (the gap's midpoint on the host's clock, its length)
    gaps = sorted((window[i][1][1] - g / 2, g)
                  for i, g in _gaps([k for k, _ in window]))
    chains = _chains(spans, [mid for mid, _ in gaps])
    launch = sum(g for (_, g), chain in zip(gaps, chains)
                 if LAUNCH_SPANS.intersection(chain))
    return launch, sum(g for _, g in gaps) - launch, len(ranges)
