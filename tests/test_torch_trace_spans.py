"""The port's host spans and what the benchmark reads from them.

On the CPU, under torch.profiler: ``fused_step.upload`` opens in both
pipelines' ``process_frame`` before the step, ``fused_dyn.associate``
holds the dynamic pipeline's host work before the dispatch and never its
tracker pass, and the tracker pass is ``fused_dyn.fetch_wait`` followed by
``fused_dyn.tracker``, at dispatch lag 1 before the association and at
lag 2 after the dispatch. On a chrome trace written out by hand (the
categories torch.profiler gives): every metric file of
``BENCHMARK.json`` reads ``benchmark.trace.Summary``, the 14 metrics of
the first benchmark and the breakdown read as they did before the new
ranges, ``loop_unspanned_ms`` takes the union of nested and overlapping
ranges, a gap inside a ``bench.gc`` range is named for it, and
``benchmark/runtime_calls.py`` counts the frame thread's synchronising
calls inside ``bench.loop``."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import configio, runtime_calls
from benchmark import trace as tr
from dynslam_tpu_torch.config import DynSlamConfig
from dynslam_tpu_torch.io.segmentation import detections_from_instance_ids
from dynslam_tpu_torch.io.synthetic import (
    SyntheticScene, render_stereo_frame, straight_trajectory,
)
from dynslam_tpu_torch.pipeline.builder import (
    build_fused_dynamic, build_fused_static,
)
from torch_threads import threads

torch_threads = threads(2)

ROOT = Path(__file__).resolve().parents[1]
W, H, N_FRAMES = 160, 120, 3
CONFIG = {
    "frame_width": W, "frame_height": H,
    "intrinsics": {"fx": 0.8 * W, "fy": 0.8 * W, "cx": W / 2, "cy": H / 2},
    "right_intrinsics": {"fx": 0.8 * W, "fy": 0.8 * W, "cx": W / 2,
                         "cy": H / 2},
    "calibration": {"baseline_m": 0.5, "focal_length_px": 0.8 * W},
    "max_depth_m": 8.0,
    "scene": {"voxel_size_m": 0.05, "mu_m": 0.30},
    "map": {"pool_capacity": 16384, "local_dims": [80, 32, 80],
            "max_new_blocks_per_frame": 4096},
    "instance_map": {"blocks_per_object": 1024, "local_dims": [48, 24, 64],
                     "max_new_blocks_per_frame": 512, "mu_m": 0.3},
    "stereo": {"max_disparity": 64},
    "vo": {"max_candidates": 1024, "max_matches": 512, "ransac_iters": 60,
           "max_disparity": 64},
    "tracker": {"min_flow_vectors": 8, "min_detection_size_px": 8},
    "decay": {"enabled": True, "min_decay_age": 2, "max_decay_weight": 1},
}
NEW = ("fused_step.upload", "fused_dyn.associate", "fused_dyn.fetch_wait",
       "fused_dyn.tracker")


@pytest.fixture(scope="module")
def frames():
    """(left gray, right gray, detections) of N_FRAMES frames of a scene
    with a moving car."""
    cfg = configio.build(DynSlamConfig, CONFIG)
    scene = SyntheticScene.default_scene(with_dynamic=True, seed=0)
    dyn_ids = [i + 1 for i, b in enumerate(scene.boxes) if b.is_dynamic]
    out = []
    for f, pose in enumerate(straight_trajectory(N_FRAMES)):
        fr = render_stereo_frame(scene, pose, cfg.intrinsics,
                                 cfg.calibration, W, H, frame=f)
        objid = np.where(np.isin(fr["object_id"], dyn_ids),
                         fr["object_id"], 0)
        out.append(tuple(np.clip(fr[k] * 255, 0, 255).astype(np.uint8)
                         for k in ("left_gray", "right_gray"))
                   + (detections_from_instance_ids(objid, min_size_px=8,
                                                   score=0.98),))
    return out


def _profiled(tmp_path, run):
    """The port's ranges of each ``run(i)`` call, each call in a
    ``test.frame`` range: [{name: [(start, end), ...]}] a frame."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(N_FRAMES):
            with record_function("test.frame"):
                run(i)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e["name"] == "test.frame")
    assert len(calls) == N_FRAMES
    out = []
    for a, b in calls:
        got = {}
        for e in events:
            if e["name"].startswith(tr.PREFIXES[:3]) and a <= e["ts"] < b:
                got.setdefault(e["name"], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
        out.append(got)
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _before(a, b) -> bool:
    """Range ``a`` ends before ``b`` starts (the trace rounds to ns)."""
    return a[1] <= b[0] + 1e-3


def test_static_upload_span(tmp_path, frames):
    """One ``fused_step.upload`` a frame, frame 0's too, before the step's
    first range and inside none of the port's other ranges."""
    cfg = configio.build(DynSlamConfig, dict(CONFIG, dynamic_mode=False))
    pipe = build_fused_static(cfg, cfg.calibration, device="cpu", seed=0)
    got = _profiled(tmp_path, lambda i: pipe.process_frame(*frames[i][:2]))
    for i, ranges in enumerate(got):
        (up,) = ranges["fused_step.upload"]
        others = [r for n, rs in ranges.items() if n not in NEW for r in rs]
        assert bool(others) == (i > 0)
        assert all(_before(up, r) for r in others)
        assert not any(n in ranges for n in NEW[1:])


@pytest.mark.parametrize("lag", [1, 2])
def test_dynamic_spans(tmp_path, frames, lag):
    """The upload first; one association a dispatch, holding none of the
    tracker's ranges; the tracker pass of the previous dispatch (frame 2
    here) as ``fetch_wait`` then ``tracker``, before the association at
    lag 1 and after the step's ranges at lag 2."""
    cfg = configio.build(DynSlamConfig, dict(CONFIG, dynamic_mode=True))
    pipe = build_fused_dynamic(cfg, cfg.calibration, device="cpu",
                               dispatch_lag=lag)
    got = _profiled(tmp_path, lambda i: pipe.process_frame(
        frames[i][0], frames[i][1], None, frames[i][2]))
    assert pipe.tracker.active_tracks, "the car was never associated"
    assert set(got[0]) == {"fused_step.upload"}
    for i, ranges in enumerate(got[1:], 1):
        (up,) = ranges["fused_step.upload"]
        (assoc,) = ranges["fused_dyn.associate"]
        step = ranges["fused_dyn.obj_ransac"] + ranges["fused_dyn.static"]
        assert _before(up, assoc) and all(_before(assoc, r) for r in step)
        if i == 1:
            assert "fused_dyn.tracker" not in ranges
            continue
        (wait,) = ranges["fused_dyn.fetch_wait"]
        (track,) = ranges["fused_dyn.tracker"]
        assert _before(wait, track)
        assert not _inside(wait, assoc) and not _inside(track, assoc)
        if lag == 1:
            assert _before(up, wait) and _before(track, assoc)
        else:
            assert all(_before(r, wait) for r in step)


# -- the benchmark's reading of a trace written out by hand ----------------

def _frame(t0):
    """One frame's events from ``t0`` (us): the first benchmark's ranges,
    their device projections and the kernels inside them."""
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
    return ev


def _new_ranges(t0):
    """The host ranges added after the first benchmark, in a frame from
    ``t0``: the upload, then after the step the tracker pass and the next
    association."""
    return [dict(name=n, cat="user_annotation", ts=t0 + s, dur=d)
            for n, s, d in (("fused_step.upload", 0, 8),
                            ("fused_dyn.fetch_wait", 360, 4),
                            ("fused_dyn.tracker", 364, 20),
                            ("fused_dyn.associate", 384, 10))]


WINDOW = [dict(name="bench.window", cat="user_annotation", ts=1000,
               dur=2000)]
BASE = WINDOW + _frame(1000) + _frame(2000) + [
    dict(name="early_k", cat="kernel", ts=500, dur=50)]
FULL = BASE + _new_ranges(1000) + _new_ranges(2000)
EXTRA = dict(k1=dict(bound_ms=0.008, launches=2), seg_worker_ms=3.5)
#: the first benchmark's 14 metrics on BASE
OLD = {
    "loop_host_ms": 0.4, "seg_worker_ms": 3.5,
    "stereo_device_ms": 0.07, "features_host_ms": 0.03,
    "egomotion_host_ms": 0.15, "egomotion_launches": 3.0,
    "allocate_host_ms": 0.02, "k1_device_ms": 0.012,
    "k1_roofline": 100 * 0.008 / 0.016, "k2_device_ms": 0.014,
    "decay_device_ms": 0.003, "obj_ransac_host_ms": 0.06,
    "instances_host_ms": 0.02, "device_idle": None,
}
#: the metrics of those ranges on FULL; unspanned: the loop less the union
#: of the port's ranges (0-8 and 10-394 us of 400) a frame
NEW_METRICS = {"upload_host_ms": 0.008, "tracker_host_ms": 0.03,
               "fetch_wait_ms": 0.004, "loop_unspanned_ms": 0.008}
#: the breakdown of BASE: the device operations by time, and the idle
#: gaps (s) by the innermost range open at their middle
BREAKDOWN = {
    "device_ops": [
        ["cost_k", 80e-6], ["census_k", 60e-6], ["gn_k", 42e-6],
        ["march_kernel(Params, Maps)", 24e-6],
        ["void integrate_kernel(int*, int*)", 24e-6], ["feat_k", 20e-6],
        ["alloc_k", 8e-6], ["decay_k", 6e-6],
        ["candidates_kernel(int const*)", 4e-6], ["Memset (Device)", 2e-6]],
    "idle_gaps": [["host", 694e-6], ["host", 374e-6],
                  ["fused_step.egomotion", 320e-6]] + [["host", 21e-6]] * 7,
}


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _want(s):
    return dict(OLD, device_idle=100 * (1 - s.busy_s / s.window_s))


def test_every_metric_file_reads_the_trace():
    """Each per-layer metric of BENCHMARK.json has its file, whose
    constants match the entry, and reads the trace with the new ranges."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    s = tr.Summary(FULL, 2, EXTRA)
    want = dict(_want(s), **NEW_METRICS)
    assert sorted(m["name"] for m in bench["per_layer"]) == sorted(want)
    for m in bench["per_layer"]:
        mod = _metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) \
            == (m["layer"], m["unit"], m["moves"])
        assert mod.read(s) == pytest.approx(want[m["name"]]), m["name"]


def test_old_metrics_and_breakdown_as_before():
    """Without the new ranges: the 14 metrics and the breakdown read what
    they read before them, the new metrics that read a range read
    nothing, and the loop is 50 us a frame outside the port's ranges.
    With them the 14 metrics read the same."""
    base, full = tr.Summary(BASE, 2, EXTRA), tr.Summary(FULL, 2, EXTRA)
    for name, want in _want(base).items():
        assert _metric(name).read(base) == pytest.approx(want), name
        assert _metric(name).read(full) == pytest.approx(want), name
    for name in ("upload_host_ms", "tracker_host_ms", "fetch_wait_ms"):
        assert _metric(name).read(base) is None, name
    assert _metric("loop_unspanned_ms").read(base) == pytest.approx(0.05)
    got = base.breakdown()
    for key, want in BREAKDOWN.items():
        assert [k for k, _ in got[key]] == [k for k, _ in want], key
        assert [v for _, v in got[key]] == pytest.approx(
            [v for _, v in want]), key


def test_loop_unspanned_takes_the_union():
    """Nested and overlapping port ranges count once; ranges outside the
    loop, and ranges of the harness, cover nothing."""
    ev = [dict(name=n, cat="user_annotation", ts=ts, dur=d)
          for n, ts, d in (("bench.window", 0, 1000),
                           ("bench.loop", 100, 100),
                           ("fused_step.a", 110, 20),
                           ("fused_step.b", 115, 10),  # inside a
                           ("fused_dyn.c", 120, 30),  # overlaps a
                           ("fused_eval.d", 190, 40),  # past the loop's end
                           ("bench.seg_worker", 150, 30),
                           ("fused_dyn.e", 300, 50),  # outside the loop
                           ("bench.loop", 400, 100))]
    s = tr.Summary(ev, 2)
    # loop 1: 100 - (110-150) - (190-200) = 50; loop 2: 100
    assert _metric("loop_unspanned_ms").read(s) == pytest.approx(0.075)
    assert _metric("loop_unspanned_ms").read(tr.Summary(ev[:1], 1)) is None


def test_gap_in_a_collector_pass_is_named_for_it():
    """The breakdown's innermost-range rule names a gap that a
    ``bench.gc`` range holds ``bench.gc``; ``gap_calls`` gives the pass's
    cover and the runtime calls that overlap the gap."""
    ev = [dict(name=n, cat=c, ts=ts, dur=d, tid=1)
          for n, c, ts, d in (
              ("bench.window", "user_annotation", 0, 1000),
              ("bench.loop", "user_annotation", 0, 1000),
              ("fused_step.decay", "user_annotation", 300, 400),
              ("bench.gc", "user_annotation", 400, 200),
              ("cudaMalloc", "cuda_runtime", 350, 30),
              ("cudaLaunchKernel", "cuda_runtime", 905, 2),
              ("k", "kernel", 0, 10),
              ("k", "kernel", 910, 10))]
    s = tr.Summary(ev, 1)
    assert s.breakdown()["idle_gaps"] == [["bench.gc", pytest.approx(
        900e-6)], ["bench.loop", pytest.approx(80e-6)]]
    (g, g2) = runtime_calls.gap_calls(s, ev)
    assert g == dict(range="bench.gc", ms=pytest.approx(0.9),
                     gc_ms=pytest.approx(0.2),
                     calls=[["cudaMalloc", pytest.approx(0.03),
                             pytest.approx(0.03)],
                            ["cudaLaunchKernel", pytest.approx(0.002),
                             pytest.approx(0.002)]])
    assert g2["calls"] == [] and g2["gc_ms"] == 0


def test_loop_syncs_count_the_frame_thread_inside_the_loop():
    """Only the synchronising calls (``cudaMemcpy`` without ``Async``
    among them) that start inside a ``bench.loop`` range on its thread."""
    loops = [dict(name="bench.loop", cat="user_annotation", ts=t, dur=100,
                  tid=1) for t in (0, 200)]
    calls = [dict(name=n, cat=c, ts=ts, dur=1, tid=tid)
             for n, c, ts, tid in (
                 ("cudaStreamSynchronize", "cuda_runtime", 50, 1),
                 ("cudaMemcpyAsync", "cuda_runtime", 60, 1),
                 ("cudaMemcpy", "cuda_runtime", 70, 1),
                 ("cudaEventSynchronize", "cuda_runtime", 150, 1),  # between
                 ("cudaStreamSynchronize", "cuda_runtime", 250, 2),  # worker
                 ("cudaLaunchKernel", "cuda_runtime", 260, 1),
                 ("cudaDeviceSynchronize", "cuda_runtime", 290, 1),
                 ("cuStreamSynchronize", "cuda_driver", 295, 1))]
    ev = loops + calls
    assert runtime_calls.loop_syncs(ev, 2) == 1.5
    assert runtime_calls.loop_calls(ev, 2) == {
        "cuStreamSynchronize": 0.5, "cudaDeviceSynchronize": 0.5,
        "cudaLaunchKernel": 0.5, "cudaMemcpy": 0.5, "cudaMemcpyAsync": 0.5,
        "cudaStreamSynchronize": 0.5}
    assert runtime_calls.syncs_by_loop(ev) == [
        {"cudaStreamSynchronize": 1, "cudaMemcpy": 1},
        {"cudaDeviceSynchronize": 1}]
    assert runtime_calls.loop_syncs(loops, 2) == 0
