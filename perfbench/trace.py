"""The traced window: a torch.profiler session over a few steps that end in a
synchronize, reduced to what the per-layer metrics read.

  busy_s      the union of the intervals in which any operation ran on the
              device (kernels, copies, fills), so that a copy on the feed's
              stream that overlaps a kernel counts once
  window_s    the profiled step's length on the host's clock
  kernels     device seconds a step, by name
  idle_gaps   the device's idle intervals, each named by the harness span
              (``perfbench.*``) the host was in at its middle
  host_step_s the host's seconds a step in the ``perfbench.step`` span, less
              the runtime calls in it that blocked (over 50 us: a full launch
              queue, a wait), so that it measures the step's dispatch and not
              the device it waits for

The session records one cycle as a warm-up, which it drops, then one more.
Where the device records come back short of the launches the program's own
wrappers counted (seen with torch 2.11 on an H100 minutes into a process), it
is run again, up to four times, and then fails: a lost kernel is never read
as a zero.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    kernels: dict[str, float]               # device seconds a step, by name
    launches: dict[str, int]                # recorded launches in the window, by name
    idle_gaps: list[tuple[str, float]]      # longest first
    host_step_s: float | None               # None: the trace holds no runtime call


#: a runtime call longer than this blocked the host
BLOCKED_S = 50e-6


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by the intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_intervals(busy: list[tuple[float, float]], lo: float, hi: float):
    """The parts of [lo, hi] that no busy interval covers."""
    gaps, cursor = [], lo
    for a, b in sorted(busy):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def name_gaps(gaps, spans: list[tuple[str, float, float]], top: int = 10):
    """[(span name, seconds)] of the ``top`` longest gaps; a gap is named by
    the innermost span around its middle, "outside" when none is."""
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        named.append((min(inside)[1] if inside else "outside", b - a))
    return named


def summarize(cpu: list[tuple[str, float, float]], gpu: list[tuple[str, float, float]],
              steps: int) -> Trace:
    """A Trace of host events (name, start, end) and device events, in
    seconds on one clock. The window is the profiler step's event."""
    windows = [(s, e) for n, s, e in cpu if n.startswith("ProfilerStep")]
    if not windows:
        raise ValueError("the trace holds no profiler step")
    lo, hi = max(windows)
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in gpu if e > lo and s < hi]
    busy = [(s, e) for _, s, e in inside]
    kernels: dict[str, float] = {}
    launches: dict[str, int] = {}
    for n, s, e in inside:
        kernels[n] = kernels.get(n, 0.0) + (e - s) / steps
        launches[n] = launches.get(n, 0) + 1
    spans = [(n, s, e) for n, s, e in cpu if n.startswith("perfbench.")]
    runtime = [(s, e) for n, s, e in cpu if n.startswith("cuda") and lo <= s and e <= hi]
    host = None
    if runtime:
        host = 0.0
        for n, s, e in spans:
            if n == "perfbench.step":
                blocked = sum(b - a for a, b in runtime if s <= a and b <= e and b - a > BLOCKED_S)
                host += (e - s - blocked) / steps
    return Trace(steps, hi - lo, union_length(busy), kernels, launches,
                 name_gaps(idle_intervals(busy, lo, hi), spans), host)


def recorded(trace: Trace, name: str) -> int:
    """Recorded launches of the kernels whose names hold ``name``."""
    return sum(n for k, n in trace.launches.items() if name in k)


def profile_steps(run: Callable[[], None], steps: int, counted: Callable[[], dict[str, int]],
                  tries: int = 4) -> Trace:
    """The Trace of ``run()`` (``steps`` steps ending in a synchronize),
    whole: every launch the wrappers counted (``counted()``: kernel name ->
    launches so far) found in the device records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     acc_events=True) as prof:
            run()
            prof.step()
            before = counted()
            run()
            prof.step()
        want = {k: n - before[k] for k, n in counted().items()}
        cpu, gpu = [], []
        for e in prof.events():
            rec = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.device_type != DeviceType.CUDA:
                cpu.append(rec)
            elif not (getattr(e, "is_user_annotation", False)
                      or e.name.startswith(("perfbench.", "ProfilerStep"))):
                # a span's mirror on the device's timeline is no device work
                gpu.append(rec)
        trace = summarize(cpu, gpu, steps)
        short = {k: (recorded(trace, k), n) for k, n in want.items() if recorded(trace, k) < n}
        if trace.busy_s > 0 and not short:
            return trace
        print(f"perfbench: profiler session {attempt} of {tries} recorded "
              f"{sum(trace.launches.values())} device operations; of the counted kernels "
              f"(recorded, counted) {short}", file=sys.stderr)
        time.sleep(1.0)
    raise RuntimeError("the profiler lost device records in every session")
