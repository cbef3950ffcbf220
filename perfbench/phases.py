"""The program's own spans and counters in a traced run, reduced to what the
per-phase metrics read.

The program marks its phases with ``simhand.*`` spans, ``record_function``
ranges (``simhand_tpu_torch/utils/trace.py``), and counts its feed's and
gather's work in ``utils.trace.counters()``. After the harness's traced
window (``trace.py``), ``of(ctx)`` profiles the cell's ``traced_steps`` once
more, the same way (a dropped warm-up cycle, then one recorded cycle ending
in a synchronize, retried while device records fall short of the launches
the wrappers counted), and reduces that session:

  host_s      host seconds a step inside each span
  dispatch_s  the same less the runtime calls in the span that blocked for
              more than ``trace.BLOCKED_S`` (``dispatch_ms``'s rule)
  device_s    device seconds a step of the operations (kernels, copies,
              fills) attributed to each span, "other" where none holds them

An operation is attributed through the runtime call that launched it, the
CPU event (``cuda*``, ``cu*``) that shares its correlation id. It belongs to the innermost ``simhand.*`` span, on the thread that
holds the harness's ``perfbench.*`` spans, whose interval holds that call's
start, whichever thread launched it: the backward's launches from
autograd's device thread count as ``simhand.step.backward``.

A program without ``utils/trace.py`` (an older commit) gets no session and
every reader returns nothing. The closures (the spans' share of the device
work, of the step's dispatch and of the feed's wait), the idle gaps named
by the innermost span, ``simhand.*`` or ``perfbench.*``, the operations no
span holds and the feed's time outside its phases are printed on standard
error as ``perfbench: phases <json>``.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import itertools
import json
import sys
import time

from perfbench.trace import BLOCKED_S, idle_intervals, name_gaps, union_length

FEED = ("simhand.feed.queue", "simhand.feed.slot_wait", "simhand.feed.pin", "simhand.feed.h2d")
STEP = ("simhand.step.augment", "simhand.step.forward", "simhand.step.loss",
        "simhand.step.backward", "simhand.step.optimizer")
HOLDERS = ("perfbench.step", "perfbench.feed")
#: names of ranges, never device work, whatever their mirrors' flags say
RANGES = ("perfbench.", "simhand.", "ProfilerStep")
PROGRAM = "simhand_tpu_torch.utils.trace"
#: a session whose operations without a launch found pass this share of the
#: device's time is made again (the profiler drops runtime records at times)
LOST_SHARE = 0.01


@dataclasses.dataclass
class Event:
    """One profiler record, in seconds on the session's one clock."""

    name: str
    start: float
    end: float
    device: bool = False          # on the card's timeline
    thread: int = 0
    corr: int = 0                 # correlation id: a launch's and its operation's
    annotation: bool = False      # a range's mirror, as the profiler flags it


@dataclasses.dataclass
class Phases:
    steps: int
    window_s: float                # the recorded cycle on the host's clock, a step
    host_s: dict[str, float]
    dispatch_s: dict[str, float]
    device_s: dict[str, float]
    device_total_s: float          # every device operation a step, as trace.py sums them
    busy_s: float                  # union of the device's busy intervals in the window
    step_dispatch_s: float | None  # the perfbench.step spans by dispatch_ms's rule
    feed_s: float                  # host seconds a step in perfbench.feed
    feed_covered_s: float          # ... of which inside a simhand.feed.* span
    idle_gaps: list[tuple[str, float]]
    links: dict[str, int]          # device operations by how their launch was found
    unlinked_s: float = 0.0        # device seconds a step whose launch was not found
    unowned: dict[str, float] = dataclasses.field(default_factory=dict)  # "other", by name
    feed_gaps: dict[str, float] = dataclasses.field(default_factory=dict)  # by the phase before
    counted: dict[str, int] = dataclasses.field(default_factory=dict)   # over the session
    lifetime: dict[str, int] = dataclasses.field(default_factory=dict)  # over the process


def is_device_work(e: Event) -> bool:
    """A device record that is an operation, not a range's mirror."""
    return e.device and not (e.annotation or e.name.startswith(RANGES))


def _innermost(spans: list[tuple[float, float, str]], starts: list[float],
               reach: list[float], t: float):
    """The name of the innermost span holding ``t``, or None. ``spans`` are
    one thread's, so nested, sorted by start and the longer first among
    equal starts; ``reach[i]`` is the latest end of spans[:i + 1]."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and reach[i] >= t:
        s, e, n = spans[i]
        if t <= e:
            return n
        i -= 1
    return None


def reduce(events: list[Event], steps: int) -> Phases | None:
    """The Phases of one recorded cycle of ``steps`` steps; None where the
    session holds no ``simhand.*`` span."""
    cpu = [e for e in events if not e.device]
    windows = [(e.start, e.end) for e in cpu if e.name.startswith("ProfilerStep")]
    if not windows:
        raise ValueError("the session holds no profiler step")
    lo, hi = max(windows)
    holders = {e.thread for e in cpu if e.name in HOLDERS}

    def on_holder(e: Event) -> bool:
        return not holders or e.thread in holders

    spans = sorted(((max(e.start, lo), min(e.end, hi), e.name) for e in cpu
                    if e.name.startswith("simhand.") and on_holder(e) and e.end > lo
                    and e.start < hi), key=lambda x: (x[0], -x[1]))
    if not spans:
        return None
    harness = [(max(e.start, lo), min(e.end, hi), e.name) for e in cpu
               if e.name in HOLDERS and on_holder(e) and e.end > lo and e.start < hi]
    blocked = [(e.start, e.end) for e in cpu if e.name.startswith("cuda")
               and lo <= e.start and e.end <= hi and e.end - e.start > BLOCKED_S]

    def unblocked(s: float, e: float) -> float:
        return e - s - sum(b - a for a, b in blocked if s <= a and b <= e)

    host: dict[str, float] = {}
    dispatch: dict[str, float] = {}
    for s, e, n in spans:
        host[n] = host.get(n, 0.0) + (e - s) / steps
        dispatch[n] = dispatch.get(n, 0.0) + unblocked(s, e) / steps
    step_spans = [(s, e) for s, e, n in harness if n == "perfbench.step"]
    step_dispatch = (sum(unblocked(s, e) for s, e in step_spans) / steps
                     if step_spans and any(e.name.startswith("cuda") for e in cpu) else None)
    feed_spans = [(s, e) for s, e, n in harness if n == "perfbench.feed"]
    feed_inner = [(s, e) for s, e, n in spans if n in FEED]
    covered = sum(union_length([(max(a, s), min(b, e)) for a, b in feed_inner
                                if b > s and a < e]) for s, e in feed_spans)
    # the feed's time in none of its phases, by the phase it follows
    feed_gaps: dict[str, float] = {}
    for s, e in feed_spans:
        inner = sorted((a, b, n) for a, b, n in spans if n in FEED and b > s and a < e)
        cursor, after = s, "start"
        for a, b, n in inner + [(e, e, "end")]:
            if a > cursor:
                feed_gaps[after] = feed_gaps.get(after, 0.0) + (a - cursor) / steps
            cursor, after = max(cursor, b), n

    # a launch by its runtime call's correlation id (CPU ops number theirs
    # apart, so only runtime calls are looked up)
    runtime = {e.corr: e.start for e in cpu if e.name.startswith("cu") and e.corr}
    starts = [s for s, _, _ in spans]
    reach = list(itertools.accumulate((e for _, e, _ in spans), max))
    device: dict[str, float] = {n: 0.0 for _, _, n in spans}
    device["other"] = 0.0
    links = {"runtime": 0, "none": 0}
    busy, total = [], 0.0
    unowned: dict[str, float] = {}
    unlinked = 0.0
    for e in events:
        if not is_device_work(e) or e.end <= lo or e.start >= hi:
            continue
        s, t = max(e.start, lo), min(e.end, hi)
        busy.append((s, t))
        total += (t - s) / steps
        launch = runtime.get(e.corr)
        route = "none" if launch is None else "runtime"
        links[route] += 1
        unlinked += (t - s) / steps if launch is None else 0.0
        owner = _innermost(spans, starts, reach, launch) if launch is not None else None
        device[owner or "other"] += (t - s) / steps
        if owner is None:
            key = f"{route}: {e.name[:80]}"
            unowned[key] = unowned.get(key, 0.0) + (t - s) / steps
    named = name_gaps(idle_intervals(busy, lo, hi), [(n, s, e) for s, e, n in spans + harness])
    return Phases(steps, (hi - lo) / steps, host, dispatch, device, total, union_length(busy),
                  step_dispatch, sum(e - s for s, e in feed_spans) / steps, covered / steps,
                  named, links, unlinked,
                  dict(sorted(unowned.items(), key=lambda kv: -kv[1])[:8]), feed_gaps)


def events_of(prof) -> list[Event]:
    """The session's records as Events."""
    from torch.autograd import DeviceType

    return [Event(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                  e.device_type == DeviceType.CUDA, e.thread, e.id,
                  bool(getattr(e, "is_user_annotation", False)))
            for e in prof.events()]


def _counters() -> dict[str, int]:
    from simhand_tpu_torch.utils import trace

    return trace.counters()


def profile_phases(cell, steps: int, tries: int = 4) -> Phases | None:
    """The Phases of ``steps`` more traced steps of ``cell``: one warm-up
    cycle, dropped, then one recorded, each ending in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    on_card = torch.device(getattr(cell, "device", "cpu")).type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    counted = getattr(cell, "launch_counts", dict)

    def run():
        for _ in range(steps):
            cell.traced_step()
        cell.sync()

    kept = None
    for attempt in range(1, tries + 1):
        t0 = time.perf_counter()
        with profile(activities=activities, acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run()
            prof.step()
            before, c0 = counted(), _counters()
            t1 = time.perf_counter()
            run()
            t2 = time.perf_counter()
            prof.step()
        c1 = _counters()
        t3 = time.perf_counter()
        want = {k: n - before.get(k, 0) for k, n in counted().items()}
        events = events_of(prof)
        print(f"perfbench: phases session {attempt}: warm-up {t1 - t0:.1f} s, recorded "
              f"{t2 - t1:.1f} s, closed in {t3 - t2:.1f} s, {len(events)} records read in "
              f"{time.perf_counter() - t3:.1f} s", file=sys.stderr)
        work = [e for e in events if is_device_work(e)]
        short = {k: (sum(1 for e in work if k in e.name), n) for k, n in want.items()}
        short = {k: v for k, v in short.items() if v[0] < v[1]}
        if on_card and (not work or short):
            print(f"perfbench: phases session {attempt} of {tries} recorded {len(work)} device "
                  f"operations; of the counted kernels (recorded, counted) {short}",
                  file=sys.stderr)
            time.sleep(1.0)
            continue
        phases = reduce(events, steps)
        if phases is not None:
            phases.counted = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
            phases.lifetime = c1
            report(phases, events)
            if phases.unlinked_s > LOST_SHARE * phases.device_total_s:
                # the operations came back but some of their launches did not
                print(f"perfbench: phases session {attempt} of {tries} lost the launches of "
                      f"{phases.unlinked_s * 1e3:.3f} of {phases.device_total_s * 1e3:.3f} "
                      "device ms a step", file=sys.stderr)
                kept = phases
                continue
        return phases
    if kept is not None:
        return kept
    raise RuntimeError("the profiler lost device records in every phases session")


def report(p: Phases, events: list[Event]) -> None:
    """The closures, the launches' links, the spans' mirrors and the named
    idle gaps, on standard error."""
    spans = sum(v for k, v in p.device_s.items() if k != "other")
    mirrors = [e for e in events if e.device and e.name.startswith("simhand.")]
    out = {
        "device_closure": spans / p.device_total_s if p.device_total_s else None,
        "device_other_share": p.device_s["other"] / p.device_total_s if p.device_total_s
        else None,
        "host_closure": (sum(p.dispatch_s.get(n, 0.0) for n in STEP) / p.step_dispatch_s
                         if p.step_dispatch_s else None),
        "feed_coverage": p.feed_covered_s / p.feed_s if p.feed_s else None,
        "device_ms": {k: v * 1e3 for k, v in p.device_s.items()},
        "host_ms": {k: v * 1e3 for k, v in p.host_s.items()},
        "dispatch_ms": {k: v * 1e3 for k, v in p.dispatch_s.items()},
        "step_dispatch_ms": None if p.step_dispatch_s is None else p.step_dispatch_s * 1e3,
        "device_total_ms": p.device_total_s * 1e3, "busy_ms": p.busy_s * 1e3 / p.steps,
        "feed_ms": p.feed_s * 1e3, "window_ms": p.window_s * 1e3, "links": p.links,
        "mirrors": [len(mirrors), sum(e.annotation for e in mirrors)],
        "counted": p.counted, "idle_gaps": p.idle_gaps,
        "unowned_ms": {k: v * 1e3 for k, v in p.unowned.items()},
        "feed_gaps_ms": {k: v * 1e3 for k, v in p.feed_gaps.items()},
    }
    print("perfbench: phases " + json.dumps(out), file=sys.stderr)


def of(ctx) -> Phases | None:
    """The Phases of ``ctx``'s traced run, made once and kept on ``ctx``;
    None off a traced run, for a cell that cannot step traced, or for a
    program without spans."""
    if "_phases" not in vars(ctx):
        phases = None
        cell = ctx.cell
        steps = getattr(getattr(cell, "spec", None), "traffic", {}).get("traced_steps")
        if (ctx.trace is not None and steps and hasattr(cell, "traced_step")
                and importlib.util.find_spec(PROGRAM) is not None):
            t = time.perf_counter()
            phases = profile_phases(cell, int(steps))
            print(f"perfbench: phases in {time.perf_counter() - t:.1f} s", file=sys.stderr)
        vars(ctx)["_phases"] = phases
    return vars(ctx)["_phases"]


def host_ms(ctx, span: str) -> float | None:
    """Host ms a step in ``span``."""
    p = of(ctx)
    return None if p is None or span not in p.host_s else p.host_s[span] * 1e3


def dispatch_ms(ctx, span: str) -> float | None:
    """Host ms a step in ``span`` less its blocked runtime calls."""
    p = of(ctx)
    return None if p is None or span not in p.dispatch_s else p.dispatch_s[span] * 1e3


def device_ms(ctx, span: str) -> float | None:
    """Device ms a step of the operations launched inside ``span``; nothing
    off the card or where the span is missing."""
    p = of(ctx)
    if p is None or span not in p.device_s or not p.device_total_s:
        return None
    return p.device_s[span] * 1e3
