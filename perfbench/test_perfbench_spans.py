"""The readers of the program's spans (``attribution.py`` and the five
``layers/`` files that use it) on hand-built traces, in microseconds:
each launch paired with its device event, each device event given to the
innermost span around its launch, and the idle time between device
events split by what the host was doing, on the host's clock."""

import numpy as np
import pytest

from perfbench import attribution, harness
from perfbench.tracing import union

# two traced iterations: a mixed one [0, 100], the serving loop, a solo
# one [110, 200]
RANGES = [("mixed", 0.0, 100.0), ("solo", 110.0, 200.0)]
SPANS = [
    ("engine.step", 0.0, 100.0),
    ("step.chunk", 2.0, 40.0),
    ("model.cache_clone", 3.0, 8.0),
    ("model.mixer", 10.0, 20.0),
    ("model.moe", 22.0, 38.0),
    ("step.write_slot", 41.0, 50.0),
    ("step.decode", 52.0, 80.0),
    ("model.mixer", 55.0, 65.0),
    ("step.merge", 70.0, 78.0),
    ("step.sync", 81.0, 85.0),
    ("step.account", 86.0, 99.0),
    ("engine.step", 110.0, 190.0),
    ("step.decode", 112.0, 160.0),
    ("model.moe", 115.0, 140.0),
    ("step.merge", 145.0, 155.0),
    ("step.sync", 160.0, 185.0),
    ("step.account", 186.0, 189.0),
]
# (launch call, its start, the device event it starts, the innermost
# span); an idle device starts an event 1 us after its launch
WORK = [
    ("cudaMemcpyAsync", 4.0, ("Memcpy DtoD", 5.0, 9.0), "model.cache_clone"),
    ("cudaLaunchKernel", 12.0, ("attn", 13.0, 22.0), "model.mixer"),
    ("cuLaunchKernelEx", 24.0, ("nvjet_gemm", 25.0, 45.0), "model.moe"),
    ("cudaMemcpyAsync", 42.0, ("Memcpy DtoD", 45.0, 53.0),
     "step.write_slot"),
    ("cudaLaunchKernel", 57.0, ("decode_kernel", 58.0, 68.0), "model.mixer"),
    ("cudaLaunchKernel", 72.0, ("where", 73.0, 80.0), "step.merge"),
    ("cudaMemcpyAsync", 82.0, ("Memcpy DtoH", 83.0, 84.0), "step.sync"),
    ("cudaLaunchKernel", 95.0, ("fill", 96.0, 97.0), "step.account"),
    ("cuLaunchKernelEx", 116.0, ("nvjet_gemm", 117.0, 140.0), "model.moe"),
    ("cudaLaunchKernel", 146.0, ("where", 147.0, 157.0), "step.merge"),
    ("cudaMemcpyAsync", 161.0, ("Memcpy DtoH", 162.0, 163.0), "step.sync"),
]
# by hand: device time 94; copies 4 + 8 + 7 + 10, the MoE 20 + 23, the
# mixer 9 + 10
DEVICE = 4 + 9 + 20 + 8 + 10 + 7 + 1 + 1 + 23 + 10 + 1
COPY, MOE, MIXER = 4 + 8 + 7 + 10, 20 + 23, 9 + 10
# kernel-free gaps in [5, 163], each at its host midpoint (the launch
# that ends it less half its length): launching 9-13 at 10 (mixer), 22-25
# at 22.5 (moe), 53-58 at 54.5 (decode), 68-73 at 69.5 (decode), 140-147
# at 142.5 (decode), 157-162 at 158.5 (decode); syncing 80-83 at 80.5
# (engine.step), 84-96 at 89 (account), 97-117 at 106 (the serving loop)
IDLE_LAUNCH = 4 + 3 + 5 + 5 + 7 + 5
IDLE_SYNC = 3 + 12 + 20


def _events(work=WORK, spans=SPANS, shift=0.0):
    """The trace as the tracer gives it; ``shift`` moves the device's
    clock against the host's."""
    host = [(n, a, b) for n, a, b in spans]
    host += [(call, t, t + 0.5) for call, t, _, _ in work]
    host.append(("aten::mm", 11.0, 21.0))
    return {"ranges": list(RANGES),
            "kernels": sorted(((n, a + shift, b + shift)
                               for _, _, (n, a, b), _ in work),
                              key=lambda k: k[1]),
            "host": host[::-1]}  # as kineto gives them: in no order


def _read(name, events):
    run = harness.Run(None, harness.load_config("grok1-2l"), {}, events,
                      None)
    return harness._reader(name, harness.HERE)(run)


def test_each_device_event_pairs_with_its_launch_and_innermost_span():
    pairs = attribution.launched_under(_events())
    assert [k for k, _ in pairs] == [k for _, _, k, _ in WORK]
    assert [chain[-1] for _, chain in pairs] == [s for *_, s in WORK]
    # the chain names every span around the launch, outermost first
    assert pairs[4][1] == ("engine.step", "step.decode", "model.mixer")


def test_device_events_the_profiler_missed_at_its_start_are_left_out():
    # the first copy's device event was not recorded: the rest still pair
    ev = _events()
    ev["kernels"] = ev["kernels"][1:]
    pairs = attribution.launched_under(ev)
    assert [chain[-1] for _, chain in pairs] == [s for *_, s in WORK[1:]]
    assert _read("copy_share", ev) == pytest.approx(
        100 * (COPY - 4) / (DEVICE - 4))


def test_launches_and_device_events_that_do_not_pair_read_none():
    late = _events()
    late["kernels"] = late["kernels"][:-1]  # a copy paired with a kernel
    extra = _events()
    extra["kernels"] = extra["kernels"] + [("stray", 300.0, 301.0)]
    for ev in (late, extra):
        assert attribution.paired(ev) is None
        for m in ("copy_share", "moe_share", "mixer_share", "idle_launch_ms",
                  "idle_sync_ms"):
            assert _read(m, ev) is None, m


def test_launches_unpaired_past_the_first_iteration_read_none():
    # the profiler misses device events only as it starts: nine launches
    # without one reach into the second iteration
    ev = _events()
    ev["kernels"] = ev["kernels"][9:]
    assert attribution.paired(ev) is None
    assert _read("moe_share", ev) is None


# kernels alone, from two runtime calls: a lost device event shifts the
# pairs before it onto launches of the same kind
CALLS = [("cudaLaunchKernel", 12.0, ("attn", 13.0, 22.0), "model.mixer"),
         ("cuLaunchKernelEx", 24.0, ("nvjet_gemm", 25.0, 45.0), "model.moe"),
         ("cudaLaunchKernel", 57.0, ("attn", 58.0, 68.0), "model.mixer"),
         ("cuLaunchKernelEx", 116.0, ("nvjet_gemm", 117.0, 140.0),
          "model.moe"),
         ("cudaLaunchKernel", 146.0, ("attn", 147.0, 157.0), "step.merge")]


def test_a_device_event_lost_mid_window_reads_none():
    ev = _events(work=CALLS)
    assert [chain[-1] for _, chain in attribution.launched_under(ev)] \
        == [s for *_, s in CALLS]
    ev["kernels"] = ev["kernels"][:2] + ev["kernels"][3:]
    assert attribution.paired(ev) is None
    assert _read("mixer_share", ev) is None


def test_host_functions_and_graph_launches():
    # a host function starts no device event and is not a launch
    ev = _events()
    ev["host"].append(("cudaLaunchHostFunc", 90.0, 90.5))
    assert _read("copy_share", ev) == pytest.approx(100 * COPY / DEVICE)
    # one graph launch starts many kernels: nothing pairs by order
    ev = _events()
    ev["host"] = [h for h in ev["host"]
                  if not (h[0].startswith("cu") and h[1] > 100)]
    ev["host"].append(("cudaGraphLaunch", 112.0, 112.5))
    assert attribution.paired(ev) is None
    assert _read("idle_launch_ms", ev) is None


def test_no_program_span_reads_zero():
    """No device time was launched under a span, and no gap fell in a
    launching phase: the shares and ``idle_launch_ms`` read 0.0, and
    ``idle_sync_ms`` all the idle time."""
    ev = _events(spans=[])
    for m in ("copy_share", "moe_share", "mixer_share", "idle_launch_ms"):
        assert _read(m, ev) == 0.0, m
    assert _read("idle_sync_ms", ev) == pytest.approx(
        (IDLE_LAUNCH + IDLE_SYNC) / 2 / 1e3)


def test_a_gap_in_step_account_is_sync():
    assert attribution.idle_split(_events()) == (IDLE_LAUNCH, IDLE_SYNC, 2)
    # inside a step.merge around step.account the same gap is launch
    ev = _events(spans=SPANS + [("step.merge", 85.5, 99.5)])
    assert attribution.idle_split(ev) == (IDLE_LAUNCH + 12, IDLE_SYNC - 12,
                                          2)


@pytest.mark.parametrize("shift", [0.0, -30.0, 45.0])
def test_the_split_reads_no_device_time_against_the_host_clock(shift):
    """The device's timestamps may drift from the host's: the split and
    the shares stay the same under any offset between the two."""
    ev = _events(shift=shift)
    assert attribution.idle_split(ev) == (IDLE_LAUNCH, IDLE_SYNC, 2)
    assert _read("moe_share", ev) == pytest.approx(100 * MOE / DEVICE)


@pytest.mark.parametrize("name,want", [
    ("copy_share", 100 * COPY / DEVICE),
    ("moe_share", 100 * MOE / DEVICE),
    ("mixer_share", 100 * MIXER / DEVICE),
    ("idle_launch_ms", IDLE_LAUNCH / 2 / 1e3),
    ("idle_sync_ms", IDLE_SYNC / 2 / 1e3),
])
def test_each_reader_reads_the_hand_worked_number(name, want):
    assert _read(name, _events()) == pytest.approx(want)


def _random_events(seed):
    """Nested spans of random steps, launches inside them, one device
    event a launch in launch order, iteration ranges around the steps."""
    rng = np.random.default_rng(seed)
    names = sorted(attribution.LAUNCH_SPANS) + ["step.sync", "step.account",
                                                "model.moe"]
    calls = ["cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync"]
    t, spans, work, ranges, dev = 0.0, [], [], [], 0.0
    for _ in range(int(rng.integers(2, 6))):
        t0 = t
        for _ in range(int(rng.integers(1, 5))):
            a = t + rng.uniform(0.1, 2)
            t = a + rng.uniform(1, 10)
            spans.append((str(rng.choice(names)), a, t))
            for c in np.sort(rng.uniform(a, t, int(rng.integers(0, 4)))):
                dev = max(dev, c) + rng.uniform(0, 3)
                k1 = dev + rng.uniform(0.1, 4)
                call = str(rng.choice(calls))
                kind = {"cudaMemcpyAsync": "Memcpy DtoD",
                        "cudaMemsetAsync": "Memset"}.get(call, "k")
                work.append((call, c, (kind, dev, k1), None))
                dev = k1
        t += rng.uniform(0, 2)
        spans.append(("engine.step", t0, t))
        ranges.append(("mixed", t0, t))
        t += rng.uniform(0, 3)
    ev = _events(work=work, spans=spans)
    ev["ranges"] = ranges
    return ev


@pytest.mark.parametrize("seed", range(7))
def test_the_two_idle_metrics_sum_to_the_idle_time(seed):
    """Their sum over the iterations is the kernel-free time from the
    first to the last device event launched in them, with program spans
    and without."""
    ev = (_events() if seed == 0 else _events(spans=[]) if seed == 6
          else _random_events(seed))
    kernels = [(a, b) for _, a, b in ev["kernels"]]
    idle = (kernels[-1][1] - kernels[0][0]) - union(kernels)
    n = len(ev["ranges"])
    got = (_read("idle_launch_ms", ev) + _read("idle_sync_ms", ev)) * n
    assert got == pytest.approx(idle / 1e3, rel=1e-9, abs=1e-12)
