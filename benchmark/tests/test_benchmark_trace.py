"""The trace summary and every metric file on a small recorded trace: two
frames' worth of chrome-trace events, written out by hand with the
categories torch.profiler gives them."""

import importlib.util
import json
from pathlib import Path

import pytest

from benchmark import trace as tr

BENCH = Path(__file__).resolve().parents[1]


def _frame(t0):
    """One frame's events from ``t0`` (us): host ranges, their device
    projections and the kernels inside them."""
    ev = [dict(name="bench.loop", cat="user_annotation", ts=t0, dur=400)]
    stages = [("fused_step.stereo", 10, 40, [("census_k", 30), ("cost_k", 40)]),
              ("fused_step.features", 50, 30, [("feat_k", 10)]),
              ("fused_step.egomotion", 80, 150,
               [("gn_k", 5), ("gn_k", 5), ("gn_k", 5)]),
              ("fused_step.allocate", 230, 20, [("alloc_k", 4)]),
              ("fused_step.integrate", 250, 10,
               [("void integrate_kernel(int*, int*)", 8)]),
              ("fused_step.raycast", 260, 10,
               [("candidates_kernel(int const*)", 2),
                ("march_kernel(Params, Maps)", 12)]),
              ("fused_step.decay", 270, 10, [("decay_k", 3)]),
              ("fused_dyn.obj_ransac", 280, 60, [("gn_k", 6)]),
              ("fused_dyn.instances", 340, 20,
               [("void integrate_kernel(int*, int*)", 4)])]
    g0 = t0 + 300
    for name, s, d, ks in stages:
        ev.append(dict(name=name, cat="user_annotation", ts=t0 + s, dur=d))
        g0 += 20
        t = g0
        for kname, kd in ks:
            ev.append(dict(name=kname, cat="kernel", ts=t, dur=kd))
            t += kd + 1
        ev.append(dict(name=name, cat="gpu_user_annotation", ts=g0,
                       dur=t - g0))
        if name == "fused_step.raycast":
            ev.append(dict(name="Memset (Device)", cat="gpu_memset",
                           ts=t - 1, dur=1))
        g0 = t
    # host ranges that launch nothing: the input copies before stereo,
    # the host tracker's association, its wait on the packed fetch and
    # its pass after it
    for name, s, d in (("fused_step.upload", 2, 6),
                       ("fused_dyn.associate", 362, 6),
                       ("fused_dyn.fetch_wait", 370, 2),
                       ("fused_dyn.tracker", 374, 14)):
        ev.append(dict(name=name, cat="user_annotation", ts=t0 + s, dur=d))
    return ev


EVENTS = ([dict(name="bench.window", cat="user_annotation", ts=1000,
                dur=2000)]
          + _frame(1000) + _frame(2000)
          + [dict(name="early_k", cat="kernel", ts=500, dur=50)])
EXTRA = dict(k1=dict(bound_ms=0.008, launches=2), seg_worker_ms=3.5)


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
    s = tr.Summary(EVENTS, 2, EXTRA)
    want = {
        "loop_host_ms": 0.4, "seg_worker_ms": 3.5,
        "stereo_device_ms": 0.07, "features_host_ms": 0.03,
        "egomotion_host_ms": 0.15, "egomotion_launches": 3.0,
        "allocate_host_ms": 0.02, "k1_device_ms": 0.012,
        "k1_roofline": 100 * 0.008 / 0.016, "k2_device_ms": 0.014,
        "decay_device_ms": 0.003, "obj_ransac_host_ms": 0.06,
        "instances_host_ms": 0.02,
        "device_idle": 100 * (1 - s.busy_s / s.window_s),
        "upload_host_ms": 0.006, "tracker_host_ms": 0.006 + 0.014,
        "fetch_wait_ms": 0.002,
        # a 400-us loop less the port's ranges in it: 2-8, 10-360 (the
        # stages end to end), 362-368, 370-372 and 374-388 us
        "loop_unspanned_ms": (400 - (6 + 350 + 6 + 2 + 14)) / 1e3,
    }
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    assert sorted(names) == sorted(want)
    for name in names:
        assert _metric(name).read(s) == pytest.approx(want[name]), name


def test_metrics_leave_out_what_they_cannot_read():
    empty = [dict(name="bench.window", cat="user_annotation", ts=0,
                  dur=100)]
    s = tr.Summary(empty, 1, {})
    for name in ("stereo_device_ms", "k1_device_ms", "k1_roofline",
                 "k2_device_ms", "device_idle", "seg_worker_ms",
                 "egomotion_launches"):
        assert _metric(name).read(s) is None, name

