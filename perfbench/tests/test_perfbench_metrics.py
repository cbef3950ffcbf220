"""The arithmetic of every metric on synthetic records: FLOPs a sample, the
NT-Xent bound, the union of busy intervals, the idle gaps and their names,
the host's dispatch, and a named kernel missing from the trace."""
from __future__ import annotations

import pytest

from perfbench import peaks
from perfbench import trace as T
from perfbench.run import Context
from perfbench.spec import load_module, load_spec
from perfbench.tests.toy import REPO


def metric(name):
    return load_module(REPO, "metrics", name)


def ctx(trace=None, cell=None, **kw):
    base = dict(cell=cell, setup_s=12.5, steps=40, samples=40 * 1024, window_s=10.0,
                feed_wait_s=0.8, window_peak_bytes=3 * 2**30, trace=trace)
    base.update(kw)
    return Context(**base)


def test_union_and_idle():
    busy = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert T.union_length(busy) == pytest.approx(3.0)
    assert T.idle_intervals(busy, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert T.idle_intervals(busy, -1.0, 4.0) == [(-1.0, 0.0), (2.0, 3.0)]


def test_summarize_synthetic_trace():
    cpu = [("ProfilerStep#1", 0.0, 10.0),
           ("perfbench.feed", 0.0, 2.0), ("perfbench.step", 2.0, 6.0),
           ("perfbench.feed", 6.0, 7.0), ("perfbench.step", 7.0, 9.0),
           ("cudaLaunchKernel", 2.5, 2.50001), ("cudaLaunchKernel", 3.0, 4.0)]
    gpu = [("conv", 1.0, 3.0), ("copy", 2.0, 4.0), ("weighted_denom_kernel<1>", 7.5, 8.0),
           ("weighted_grad_kernel", 8.0, 8.5), ("sum_splits_kernel<128>", 8.5, 8.75),
           ("late", 9.5, 11.0)]
    t = T.summarize(cpu, gpu, steps=2)
    assert t.window_s == 10.0
    assert t.busy_s == pytest.approx(3.0 + 1.25 + 0.5)          # the copy counted once
    assert t.kernels["conv"] == pytest.approx(1.0)
    assert t.kernels["late"] == pytest.approx(0.25)              # clipped at the window
    names = dict((round(s, 6), n) for n, s in t.idle_gaps)
    assert names[3.5] == "perfbench.step"                        # 4.0 .. 7.5
    assert names[1.0] == "perfbench.feed"                        # 0.0 .. 1.0
    assert names[0.75] == "outside"                              # 8.75 .. 9.5
    # (4 + 2) s of step spans, 1 s blocked in a launch, over 2 steps
    assert t.host_step_s == pytest.approx(2.5)
    assert metric("idle_share").read(ctx(t)) == pytest.approx((1 - 4.75 / 10) * 100)
    assert metric("dispatch_ms").read(ctx(t)) == pytest.approx(2500.0)


def test_summarize_without_runtime_calls():
    t = T.summarize([("ProfilerStep#0", 0.0, 1.0)], [("k", 0.0, 0.5)], steps=1)
    assert t.host_step_s is None
    assert metric("dispatch_ms").read(ctx(t)) is None
    with pytest.raises(ValueError):
        T.summarize([], [("k", 0.0, 0.5)], steps=1)


class _Cell:
    flops_per_sample = 16.07e9
    ntxent_rows = 2048


def test_ntxent_roofline():
    m = metric("ntxent_roofline")
    # 2048^2 pairs: #2 on the CUDA cores (154 operations a pair), #4 on the
    # tensor cores (three TF32 passes of 4 * 128 flops a pair)
    pairs = 2048.0 ** 2
    denom = pairs * 154 / peaks.FP32_OPS_PER_S
    grad = 3 * pairs * 4 * 128 / peaks.TF32_TENSOR_OPS_PER_S
    assert m.bound_s("weighted_ntxent_denominator", 2048, 2048) == pytest.approx(denom)
    assert m.bound_s("weighted_grad_rows", 2048, 2048) == pytest.approx(grad)
    t = T.Trace(1, 1.0, 0.5, {"weighted_denom_kernel<4>": 1e-4, "weighted_grad_kernel": 2e-4,
                              "sum_splits_kernel<1>": 5e-5, "other": 1.0}, {}, [], None)
    assert m.read(ctx(t, _Cell())) == pytest.approx((denom + grad) / 3.5e-4 * 100)
    assert m.read(ctx(None, _Cell())) is None


def test_ntxent_roofline_missing_kernel_is_an_error():
    t = T.Trace(1, 1.0, 0.5, {"weighted_grad_kernel": 2e-4}, {}, [], None)
    with pytest.raises(RuntimeError, match="weighted_denom_kernel"):
        metric("ntxent_roofline").read(ctx(t, _Cell()))


@pytest.mark.parametrize("cell,flops", [("rn50_pretrain", 16.07e9), ("rn152_pretrain", 45.26e9)])
def test_flops_a_sample(cell, flops):
    spec = load_spec(REPO, cell)
    drv = load_module(REPO, "drivers", spec.config["driver"])
    c = drv.Cell(spec, 1, "cpu", "/nonexistent")
    # bench.py's table: 8.2 / 23.1 GFLOP forward at 224^2, (128/224)^2, x3, x2 views
    assert c.flops_per_sample == pytest.approx(flops, rel=1e-3)
    assert c.samples_per_step == 1024 and c.ntxent_rows == 2048
    mfu = metric("step_mfu").read(ctx(cell=c))
    assert mfu == pytest.approx(c.flops_per_sample * 4096.0 / 989e12 * 100)


def test_end_to_end_and_memory():
    c = ctx()
    assert metric("samples_per_s").read(c) == pytest.approx(4096.0)
    assert metric("setup_s").read(c) == 12.5
    assert metric("feed_wait_ms").read(c) == pytest.approx(20.0)
    assert metric("peak_mem_gib").read(c) == pytest.approx(3.0)
    assert metric("peak_mem_gib").read(ctx(window_peak_bytes=None)) is None
