"""The program's spans and counters as the per-phase metrics read them
(``perfbench/phases.py``): device operations attributed by the launch that
made them, the host split, the spans' mirrors kept out of the device's work,
idle gaps named by the innermost span, each of the fourteen readers on
synthetic records, and one traced session of the toy cell on the CPU."""
from __future__ import annotations

import types

import pytest
import torch

from perfbench import phases as P
from perfbench import trace as T
from perfbench.run import Context, read_metrics
from perfbench.spec import load_module, load_spec
from perfbench.tests.toy import REPO, toy_root

MAIN, AUTOGRAD, WORKER = 1, 2, 3
PHASES = ("augment", "forward", "loss", "backward", "optimizer")
READERS = (["feed_queue_ms", "feed_pin_ms", "h2d_gbps", "gather_gbps"]
           + [f"{p}_host_ms" for p in PHASES] + [f"{p}_device_ms" for p in PHASES])


def E(name, start, end, **kw):
    return P.Event(name, start, end, **kw)


def launch(corr, start, thread=MAIN):
    return E("cudaLaunchKernel", start, start + 1e-5, thread=thread, corr=corr)


def op(name, start, end, corr):
    return E(name, start, end, device=True, corr=corr)


def step_events() -> list:
    """One step of 10 s: the feed (0-2 s: queue, pin, h2d) and the step
    (2-9 s: forward 2-4, loss 4-5, backward 5-8 with its launches on
    autograd's thread, optimizer 8-9); one kernel launched outside."""
    return [
        E("ProfilerStep#1", 0.0, 10.0, thread=MAIN),
        E("perfbench.feed", 0.0, 2.0, thread=MAIN),
        E("simhand.feed.queue", 0.0, 1.0, thread=MAIN),
        E("simhand.feed.pin", 1.0, 1.5, thread=MAIN),
        E("simhand.feed.h2d", 1.5, 1.9, thread=MAIN),
        E("perfbench.step", 2.0, 9.5, thread=MAIN),
        E("simhand.step.forward", 2.0, 4.0, thread=MAIN),
        E("simhand.step.loss", 4.0, 5.0, thread=MAIN),
        E("simhand.step.backward", 5.0, 8.0, thread=MAIN),
        E("simhand.step.optimizer", 8.0, 9.0, thread=MAIN),
        E("cudaMemcpyAsync", 1.6, 1.6001, thread=MAIN, corr=10),
        launch(11, 2.5),
        E("cudaStreamSynchronize", 3.0, 3.5, thread=MAIN),        # blocked 0.5 s in forward
        launch(12, 4.2),
        launch(13, 5.5, thread=AUTOGRAD),
        launch(14, 9.2),                                          # outside every span
        op("Memcpy HtoD (Pinned -> Device)", 1.7, 2.1, 10),
        op("conv_fwd", 2.6, 3.6, 11),
        op("weighted_denom_kernel", 4.3, 4.8, 12),
        op("conv_dgrad", 5.6, 7.6, 13),
        op("late_kernel", 9.3, 9.5, 14),
    ]


def test_device_operations_follow_their_launch():
    p = P.reduce(step_events(), steps=1)
    assert p.device_s["simhand.step.forward"] == pytest.approx(1.0)
    assert p.device_s["simhand.step.loss"] == pytest.approx(0.5)
    # launched from autograd's thread while the main thread was in backward
    assert p.device_s["simhand.step.backward"] == pytest.approx(2.0)
    assert p.device_s["simhand.feed.h2d"] == pytest.approx(0.4)
    # launched outside every span
    assert p.device_s["other"] == pytest.approx(0.2)
    assert p.device_s["simhand.step.optimizer"] == 0.0
    assert p.device_total_s == pytest.approx(4.1)
    assert p.links == {"runtime": 5, "none": 0}


def test_operation_without_its_launch_is_other():
    """An operation whose runtime call the session lost is "other", and
    counted as unlinked."""
    events = step_events() + [E("lost", 6.0, 6.5, device=True, corr=902)]
    p = P.reduce(events, steps=1)
    assert p.device_s["simhand.step.backward"] == pytest.approx(2.0)
    assert p.device_s["other"] == pytest.approx(0.7)
    assert p.links == {"runtime": 5, "none": 1}
    assert p.unlinked_s == pytest.approx(0.5)
    assert p.unowned == {"none: lost": pytest.approx(0.5),
                         "runtime: late_kernel": pytest.approx(0.2)}


def test_host_split_and_feed_coverage():
    p = P.reduce(step_events(), steps=2)
    assert p.host_s["simhand.step.forward"] == pytest.approx(1.0)
    assert p.dispatch_s["simhand.step.forward"] == pytest.approx(0.75)   # less 0.5 s blocked
    assert p.dispatch_s["simhand.step.backward"] == pytest.approx(1.5)
    assert p.host_s["simhand.feed.queue"] == pytest.approx(0.5)
    # dispatch_ms's rule on the whole step: 7.5 s less 0.5 s blocked, over 2
    assert p.step_dispatch_s == pytest.approx(3.5)
    assert p.feed_s == pytest.approx(1.0)
    assert p.feed_covered_s == pytest.approx(0.95)
    assert p.feed_gaps == {"simhand.feed.h2d": pytest.approx(0.05)}      # 1.9 .. 2.0 s


def test_nested_spans_take_the_innermost():
    events = step_events() + [E("simhand.step.inner", 2.4, 2.8, thread=MAIN)]
    p = P.reduce(events, steps=1)
    assert p.device_s["simhand.step.inner"] == pytest.approx(1.0)
    assert p.device_s["simhand.step.forward"] == 0.0


def test_spans_of_other_threads_hold_nothing():
    """Only the thread that holds the harness's spans places operations."""
    events = step_events() + [E("simhand.step.forward", 9.1, 9.4, thread=WORKER)]
    assert P.reduce(events, steps=1).device_s["other"] == pytest.approx(0.2)


@pytest.mark.parametrize("flagged", [True, False])
def test_mirrors_are_no_device_work(flagged):
    """The spans' mirrors on the device's timeline, flagged as annotations
    or not, change neither the busy time nor the operations' sum."""
    mirrors = [E(n, s, e, device=True, annotation=flagged)
               for n, s, e in (("simhand.step.backward", 5.5, 7.9),
                               ("simhand.feed.h2d", 1.5, 9.9),
                               ("perfbench.step", 2.0, 9.9))]
    plain, mirrored = P.reduce(step_events(), 1), P.reduce(step_events() + mirrors, 1)
    assert mirrored.busy_s == plain.busy_s
    assert mirrored.device_total_s == plain.device_total_s
    assert mirrored.device_s == plain.device_s
    assert mirrored.idle_gaps == plain.idle_gaps


class _Prof:
    """A stand-in for a torch.profiler session yielding fixed records."""

    def __init__(self, records):
        self.records = records

    def __call__(self, **kw):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass

    def events(self):
        return self.records


def _record(name, start, end, device=False, annotation=False):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start * 1e6, end=end * 1e6),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def test_events_of_a_session():
    """The records' fields as torch's FunctionEvent has them (no linked
    correlation id, as in torch 2.11), in seconds."""
    rec = _record("cudaLaunchKernel", 1.0, 1.5)
    rec.thread, rec.id = 7, 42
    mirror = _record("simhand.step.loss", 2.0, 3.0, device=True, annotation=True)
    mirror.thread, mirror.id = 0, 0
    got = P.events_of(_Prof([rec, mirror]))
    assert got == [P.Event("cudaLaunchKernel", 1.0, 1.5, False, 7, 42, False),
                   P.Event("simhand.step.loss", 2.0, 3.0, True, 0, 0, True)]


def test_flagged_mirrors_leave_the_harness_trace_unchanged(monkeypatch):
    """trace.py's session with the program's spans and their flagged
    mirrors added: busy_s, kernels and the six accepted metrics as before."""
    import torch.profiler

    base = [_record(e.name, e.start, e.end, device=e.device) for e in step_events()
            if not e.name.startswith("simhand.")]
    spans = [_record(e.name, e.start, e.end) for e in step_events()
             if e.name.startswith("simhand.")]
    mirrors = [_record(e.name, e.start, e.end, device=True, annotation=True)
               for e in step_events() if e.name.startswith("simhand.")]
    traces = []
    for records in (base, base + spans + mirrors):
        monkeypatch.setattr(torch.profiler, "profile", _Prof(records))
        traces.append(T.profile_steps(lambda: None, 1, dict))
    plain, spanned = traces
    assert spanned.busy_s == plain.busy_s and spanned.kernels == plain.kernels
    assert spanned.host_step_s == plain.host_step_s
    spec = load_spec(REPO, "rn50_pretrain")
    old = [m for m in spec.per_layer if m["name"] not in READERS]
    assert len(old) == 6

    def ctx(t):
        return Context(None, 1.0, 4, 4096, 2.0, 0.25, 2**30, t)

    assert read_metrics(spec, old, ctx(spanned)) == read_metrics(spec, old, ctx(plain))


def test_gap_named_by_the_innermost_span():
    """An idle gap while the host sat in the pin copy inside the feed is
    named by the pin copy; one in the feed but in none of its phases by the
    harness's span."""
    events = [E("ProfilerStep#1", 0.0, 10.0, thread=MAIN),
              E("perfbench.feed", 0.0, 4.0, thread=MAIN),
              E("simhand.feed.queue", 0.0, 1.0, thread=MAIN),
              E("simhand.feed.pin", 1.0, 3.0, thread=MAIN),
              E("simhand.feed.h2d", 3.0, 3.5, thread=MAIN),
              E("perfbench.step", 4.0, 10.0, thread=MAIN),
              E("simhand.step.forward", 4.0, 10.0, thread=MAIN),
              launch(1, 0.5), launch(2, 3.1), launch(3, 4.5),
              op("a", 0.0, 1.5, 1), op("b", 2.5, 3.6, 2), op("c", 3.9, 10.0, 3)]
    gaps = P.reduce(events, 1).idle_gaps
    assert [n for n, _ in gaps] == ["simhand.feed.pin", "perfbench.feed"]
    assert [round(s, 6) for _, s in gaps] == [1.0, 0.3]


def _phases() -> P.Phases:
    """Two steps' worth: 0.5 GB copied a batch in 10 ms of device time a
    step, 3 GB gathered in 0.5 s."""
    host = {"simhand.feed.queue": 0.020, "simhand.feed.pin": 0.030}
    dispatch = {f"simhand.step.{p}": 0.001 * (i + 1) for i, p in enumerate(PHASES)}
    device = {f"simhand.step.{p}": 0.010 * (i + 1) for i, p in enumerate(PHASES)}
    device.update({"simhand.feed.h2d": 0.010, "other": 0.001})
    return P.Phases(2, 0.2, host, dispatch, device, 0.161, 0.15, 0.016, 0.06, 0.058, [],
                    {"runtime": 1, "none": 0},
                    counted={"feed.h2d_bytes": 2 * 500_000_000, "feed.batches": 2},
                    lifetime={"gather.bytes": 3_000_000_000, "gather.busy_ns": 500_000_000})


def ctx(phases=None, trace=True):
    c = Context(None, 1.0, 4, 4096, 2.0, 0.25, 2**30, object() if trace else None)
    if phases is not None:
        vars(c)["_phases"] = phases
    return c


def metric(name):
    return load_module(REPO, "metrics", name)


EXPECTED = {"feed_queue_ms": 20.0, "feed_pin_ms": 30.0, "h2d_gbps": 50.0, "gather_gbps": 6.0,
            **{f"{p}_host_ms": float(i + 1) for i, p in enumerate(PHASES)},
            **{f"{p}_device_ms": 10.0 * (i + 1) for i, p in enumerate(PHASES)}}


@pytest.mark.parametrize("name", READERS)
def test_reader_arithmetic(name):
    assert metric(name).read(ctx(_phases())) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing(name):
    """Off a traced run, or on a program without spans or counters (the
    parent's), each reader returns nothing."""
    assert metric(name).read(ctx(trace=False)) is None
    empty = P.Phases(2, 0.2, {}, {}, {"other": 0.0}, 0.0, 0.0, None, 0.0, 0.0, [], {})
    assert metric(name).read(ctx(empty)) is None


def test_program_without_spans_reads_nothing(monkeypatch):
    """No ``utils/trace.py`` in the program: no session is run."""
    monkeypatch.setattr(P, "PROGRAM", "simhand_tpu_torch.utils.no_such_module")
    cell = types.SimpleNamespace(spec=types.SimpleNamespace(traffic={"traced_steps": 2}),
                                 traced_step=lambda: pytest.fail("stepped"))
    c = Context(cell, 1.0, 4, 4096, 2.0, 0.25, 2**30, object())
    assert P.of(c) is None
    spec = load_spec(REPO, "rn50_pretrain")
    new = [m for m in spec.per_layer if m["name"] in READERS]
    assert len(new) == 14 and read_metrics(spec, new, c) == {}


def test_toy_session_on_the_cpu(tmp_path):
    """The toy cell's traced steps profiled on the CPU: the five step phases
    and the feed's queue are read; nothing of the device."""
    root = toy_root(str(tmp_path))
    spec = load_spec(root, "toy")
    torch.manual_seed(0)
    cell = load_module(root, "drivers", spec.config["driver"]).Cell(
        spec, 5, torch.device("cpu"), str(tmp_path / "work"))
    try:
        cell.setup()
        c = Context(cell, 1.0, 1, 8, 1.0, 0.0, None, object())
        p = P.of(c)
        assert P.of(c) is p
        assert set(P.STEP) | {"simhand.feed.queue"} <= set(p.host_s)
        assert all(p.dispatch_s[n] > 0 for n in P.STEP)
        entries = [m for m in load_spec(root, "rn50_pretrain").per_layer if m["name"] in READERS]
        out = read_metrics(spec, entries, c)
        want = {"feed_queue_ms", "gather_gbps"} | {f"{x}_host_ms" for x in PHASES}
        assert set(out) == want
        assert p.step_dispatch_s is None            # no runtime call on the CPU
    finally:
        cell.close_program()
