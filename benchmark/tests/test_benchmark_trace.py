"""The trace summary and every metric file on a small recorded trace: two
frames' worth of chrome-trace events, written out by hand with the
categories torch.profiler gives them (``guards.EVENTS``)."""

import importlib.util
from pathlib import Path

import pytest

from benchmark import trace as tr
from benchmark.tests import guards
from benchmark.tests.guards import EVENTS, EXTRA

BENCH = Path(__file__).resolve().parents[1]


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_summary():
    s = tr.Summary(EVENTS, 2, EXTRA)
    assert s.window_s == pytest.approx(2000e-6)
    assert s.stage("fused_step.stereo", "host_ms") == pytest.approx(0.04)
    assert s.stage("fused_step.stereo", "device_ms") == pytest.approx(0.07)
    assert s.stage("fused_step.egomotion", "launches") == 3
    assert s.stage("fused_step.raycast", "memsets") == 1
    assert s.stage("fused_step.nothing", "host_ms") is None
    assert s.kernel_ms("integrate_kernel") == pytest.approx(0.012)
    assert s.kernel_ms("integrate_kernel", "fused_step.integrate") \
        == pytest.approx(0.008)
    assert s.kernel_ms("early_k") is None  # before the window
    busy = sum(d for e in EVENTS if e["cat"] in ("kernel", "gpu_memset")
               and e["ts"] >= 1000 for d in [e["dur"]])
    assert s.busy_s == pytest.approx(busy / 1e6)
    b = s.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0] == "census_k" or b["device_ops"][0][1] \
        >= dict(b["device_ops"])["census_k"]
    # the longest idle gap: from the end of frame 1's device work to
    # frame 2's first kernel, while frame 2's host ranges ran
    assert b["idle_gaps"][0] == ["host", pytest.approx(b["idle_gaps"][0][1])]
    assert b["idle_gaps"][0][1] > 300e-6
    # the window's first 320 us: the innermost range open at its middle
    assert ["fused_step.egomotion", pytest.approx(320e-6)] in b["idle_gaps"]


def test_every_metric_file_reads_the_trace():
    """The 18 known metrics read what they read by hand; any other metric
    of BENCHMARK.json has its file, reads None or a number, and lists
    cells of BENCHMARK.json."""
    guards.metric_files_read_the_trace()


def test_metrics_leave_out_what_they_cannot_read():
    empty = [dict(name="bench.window", cat="user_annotation", ts=0,
                  dur=100)]
    s = tr.Summary(empty, 1, {})
    for name in ("stereo_device_ms", "k1_device_ms", "k1_roofline",
                 "k2_device_ms", "device_idle", "seg_worker_ms",
                 "egomotion_launches"):
        assert _metric(name).read(s) is None, name


class _Op:
    """A profiler's raw event as ``trace.device_busy`` reads it."""

    def __init__(self, device, t0, dur, annotation=False):
        self.device, self.t0, self.dur = device, t0, dur
        self.annotation = annotation

    def device_type(self):
        return self.device

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.t0

    def duration_ns(self):
        return self.dur


def test_device_clock_takes_the_union_of_device_operations():
    """Overlapping, nested and touching kernels, copies and memsets count
    once; host events and ranges projected on the device do not count."""
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    ops = [_Op(cuda, 100, 50), _Op(cuda, 120, 10),  # nested
           _Op(cuda, 140, 30),  # overlaps: 100-170
           _Op(cuda, 170, 5),  # touches: 170-175
           _Op(cuda, 1000, 1),
           _Op(cpu, 0, 5000), _Op(cuda, 0, 9000, annotation=True)]
    busy, n = tr.device_busy(reversed(ops))
    assert n == 5
    assert busy == pytest.approx(76e-9)
    assert tr.device_busy([]) == (0.0, 0)
