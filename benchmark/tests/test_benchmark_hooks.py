"""The harness's hooks for a cell added as files alone: LIDAR scans in the
cell's folder (``lidar.py``), the port's in-loop evaluation on the timed
path, check plug-ins (``checks/<name>.py``) and metrics that collect from
the pipeline (``collect``). Tiny cells on the CPU; the committed cells
load as before, in the folders they had."""

import json
import os
import textwrap
import time

import numpy as np
import pytest

from benchmark import configio, harness, lidar, scene
from benchmark.tests import guards, tiny

#: a plug-in that reads the evaluation's CSV folder: 1 for each checked
#: frame without a depth row
ROWS = '''
    import contextlib, glob, os

    READINGS = ("rows_missing",)


    @contextlib.contextmanager
    def probe(pipe, frames, run):
        yield {"evaluating": pipe.evaluation is not None}


    def gaps(captured, su, run):
        rows = set()
        for p in glob.glob(os.path.join(run["csv_dir"],
                                        "*-unified-depth-result.csv")):
            with open(p) as f:
                rows |= {int(line.split(",")[0]) for line in f.readlines()[1:]}
        ok = captured["evaluating"]
        return {fi: {"rows_missing": float(not ok or fi not in rows)}
                for fi in run["frames"]}


    control_gaps = gaps
'''
#: a plug-in whose reading is 1 on every checked frame
OVER = '''
    import contextlib

    READINGS = ("always_one",)


    @contextlib.contextmanager
    def probe(pipe, frames, run):
        yield None


    def gaps(captured, su, run):
        return {fi: {"always_one": 1.0} for fi in run["frames"]}


    control_gaps = gaps
'''
#: a plug-in that gives no reading
SILENT = '''
    import contextlib

    READINGS = ("never_read",)


    @contextlib.contextmanager
    def probe(pipe, frames, run):
        yield None


    def gaps(captured, su, run):
        return {}


    control_gaps = gaps
'''
#: a metric that collects the evaluation's jobs from the pipeline
JOBS = '''
    LAYER = "evaluation"
    UNIT = "jobs"
    MOVES = "fps"


    def collect(pipe, frames):
        return {"jobs": len(pipe.evaluation.job_ms), "frames": list(frames)}


    def read(s):
        got = s.extra.get("eval_jobs_seen")
        return None if got is None else float(got["jobs"])
'''


def _write(path, body):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(body))


def _cell(root, name, base, limits, conf_extra=None):
    """Workload ``name``: tiny cell ``base`` with ``limits`` and, where
    given, a configuration of its own, ``base``'s with ``conf_extra``."""
    config = base
    if conf_extra is not None:
        conf = json.loads((root / "configs" / f"{base}.json").read_text())
        conf.update(conf_extra)
        config = name
        (root / "configs" / f"{name}.json").write_text(json.dumps(conf))
    w = json.loads((root / "workloads" / f"{base}.json").read_text())
    w.update(config=config, limits=limits)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(w))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells, three plug-ins, the collecting metric, and the
    cells ``tiny-eval`` (the dynamic one with KITTI's rig), ``tiny-over``
    and ``tiny-silent`` (the static one with a plug-in's reading)."""
    root = tiny.make_root(tmp_path_factory.mktemp("hooks"))
    _write(root / "checks" / "rows_seen.py", ROWS)
    _write(root / "checks" / "over.py", OVER)
    _write(root / "checks" / "silent.py", SILENT)
    _write(root / "metrics" / "eval_jobs_seen.py", JOBS)
    _cell(root, "tiny-eval", "tiny-dynamic",
          dict(tiny.limits(True), rows_missing=0),
          {"lidar": lidar.HDL64E})
    _cell(root, "tiny-over", "tiny-static",
          dict(tiny.limits(False), always_one=0))
    _cell(root, "tiny-silent", "tiny-static",
          dict(tiny.limits(False), never_read=0))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="eval_jobs_seen", unit="jobs", better="higher",
        source="program_counter", layer="evaluation", moves="fps",
        workloads=["tiny-eval"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


# -- the scans -----------------------------------------------------------

def _tiny_drive():
    return scene.make_drive({**tiny.ROAD, "cars": tiny.CARS}, 8)


def _tiny_intr():
    c = tiny.CONFIG["intrinsics"]
    return c["fx"], c["fy"], c["cx"], c["cy"]


def test_kitti_rig_is_the_hdl64e():
    """KITTI's Velodyne HDL-64E: 64 beams from +2.0 to -24.8 degrees,
    0.09-degree azimuth steps across the left camera's field, 120 m, the
    20,000 points a scan of the port's bench."""
    assert lidar.HDL64E == {"beams": 64, "elevation_deg": [2.0, -24.8],
                            "azimuth_step_deg": 0.09, "max_range_m": 120.0,
                            "max_points": 20000}
    d = lidar.directions(lidar.HDL64E, _tiny_intr(), tiny.W)
    el = np.degrees(np.arcsin(d[:, 2])).reshape(64, -1)
    assert np.allclose(el[:, 0], np.linspace(2.0, -24.8, 64))
    az = np.degrees(np.arctan2(d[:, 1], d[:, 0])).reshape(64, -1)
    assert np.allclose(np.diff(az, axis=1), -0.09)
    # the columns' azimuths from the camera, two steps beyond each side
    fx, _, cx, _ = _tiny_intr()
    half_left = np.degrees(np.arctan((cx + 0.5) / fx))
    half_right = np.degrees(np.arctan((tiny.W - 0.5 - cx) / fx))
    assert half_left + 0.18 <= az[0, 0] < half_left + 0.27 + 1e-9
    assert -half_right - 0.27 - 1e-9 < az[0, -1] <= -half_right - 0.18


def test_scan_lies_on_the_rendered_surfaces():
    """Of a tiny scan's points (in the left image by construction), at
    least 98% lie within 2 cm of the depth ``scene.left_depth_ids`` casts
    along their own camera ray: at 16x the camera's resolution, the
    inverse depth of the four pixel centres around the point's
    projection, bilinearly (exact on a plane). The rest is occlusion
    from the scanner's 5 cm offset and silhouettes."""
    drive = _tiny_drive()
    frames = [0, 5]
    intr = _tiny_intr()
    got = lidar.scans(drive, frames, lidar.HDL64E, intr, tiny.W, tiny.H,
                      "cpu")
    s = 16
    fx, fy, cx, cy = intr
    hi = (fx * s, fy * s, cx * s + (s - 1) / 2, cy * s + (s - 1) / 2)
    depth, _ = scene.left_depth_ids(drive, frames, hi, tiny.W * s,
                                    tiny.H * s, "cpu")
    T = lidar.VELO_TO_CAM
    for pts, d in zip(got, depth):
        assert pts.dtype == np.float32 and pts.shape == (20000, 4)
        assert (pts[:, 3] == lidar.REFLECTANCE).all()
        cam = pts[:, :3].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        z = cam[:, 2]
        u = cam[:, 0] / z * hi[0] + hi[2]
        v = cam[:, 1] / z * hi[1] + hi[3]
        assert ((np.round(cam[:, 0] / z * fx + cx) >= 0)
                & (np.round(cam[:, 0] / z * fx + cx) < tiny.W)
                & (np.round(cam[:, 1] / z * fy + cy) >= 0)
                & (np.round(cam[:, 1] / z * fy + cy) < tiny.H)).all()
        u0 = np.clip(np.floor(u).astype(int), 0, tiny.W * s - 2)
        v0 = np.clip(np.floor(v).astype(int), 0, tiny.H * s - 2)
        a, b = np.clip(u - u0, 0, 1), np.clip(v - v0, 0, 1)
        q = [d[v0, u0], d[v0, u0 + 1], d[v0 + 1, u0], d[v0 + 1, u0 + 1]]
        inv = [np.where(x > 0, 1 / np.maximum(x, 1e-9), 0) for x in q]
        iv = (1 - a) * (1 - b) * inv[0] + a * (1 - b) * inv[1] \
            + (1 - a) * b * inv[2] + a * b * inv[3]
        truth = np.where(np.all([x > 0 for x in q], 0),
                         1 / np.maximum(iv, 1e-12), 0)
        assert np.mean(np.abs(truth - z) < 0.02) >= 0.98


def test_scans_are_written_alike(tmp_path):
    """Two writes of a drive's scans are byte for byte the same; the
    files are KITTI's: float32 rows of x, y, z, reflectance."""
    drive = _tiny_drive()
    rig = dict(lidar.HDL64E, max_points=5000)
    out = []
    for k in range(2):
        folder = tmp_path / f"w{k}"
        n_pts, n_bytes = lidar.write(str(folder), drive, rig, _tiny_intr(),
                                     tiny.W, tiny.H, "cpu", chunk=3)
        files = sorted((folder / "velodyne").iterdir())
        assert [f.name for f in files] == [f"{i:06d}.bin" for i in range(8)]
        assert n_bytes == 16 * n_pts == sum(f.stat().st_size for f in files)
        out.append([f.read_bytes() for f in files])
    assert out[0] == out[1]
    assert np.fromfile(files[0], np.float32).reshape(-1, 4).shape[0] == 5000


def test_rig_is_validated():
    with pytest.raises(ValueError):
        lidar.validate(dict(lidar.HDL64E, beams=0))
    with pytest.raises(ValueError):
        lidar.validate({k: v for k, v in lidar.HDL64E.items()
                        if k != "max_points"})


# -- the cells ------------------------------------------------------------

def test_evaluation_runs_on_the_timed_path(root, monkeypatch):
    """A tiny dynamic cell with KITTI's rig: the port's evaluation reads
    the scans, writes a depth row for every window frame, and the run is
    correct; the plug-in reads the rows of the checked frames from the
    CSV folder, which is gone after the run; a traced run hands the
    collecting metric what it collected from the pipeline."""
    monkeypatch.setattr(harness, "TRACE_FRAMES", 1)
    r = harness.run_cell("tiny-eval", 7, 2.0, True, time.perf_counter(),
                         root=root,
                         bench_json=root / "BENCHMARK.json", device="cpu")
    assert r["correct"], r["checks"]
    assert r["checks"]["rows_missing"] == {"value": 0.0, "limit": 0.0}
    ev = r["evaluation"]
    assert ev["window_frames_without_rows"] == []
    assert ev["depth_rows"] >= r["attempted"] >= 1
    assert ev["scans"] == ev["depth_rows"] and ev["job_ms_median"] > 0
    assert ev["failed_fetches"] == 0
    assert r["metrics"]["eval_jobs_seen"]["value"] >= 1
    assert not os.path.exists(os.path.join(
        os.environ.get("TMPDIR", "/tmp"), f"bench_csv_{os.getpid()}"))
    folder = root / ".cache"
    [cell] = [p for p in folder.iterdir() if p.name.startswith("tiny-eval")]
    n = harness.cell_frames(configio.load_workload("tiny-eval", root), 2.0)
    assert len(list((cell / "velodyne").iterdir())) == n


@pytest.mark.parametrize("name,reading", [("tiny-over", "always_one"),
                                          ("tiny-silent", "never_read")])
def test_plugin_faults_fail_the_run(root, name, reading):
    """A plug-in reading over its limit fails the run; so does a plug-in
    that gives no reading for a checked frame."""
    r = tiny.run(root, name)
    assert not r["correct"]
    if reading == "always_one":
        assert r["checks"]["always_one"]["value"] == 1.0
    else:
        assert reading not in r["checks"]
    # the built-in check is untouched by either
    assert all(r["checks"][k]["value"] == 0 for k in tiny.limits(False))


def test_limits_need_a_producer(root):
    """A limit that neither the built-in check nor a plug-in gives is
    refused at load, as is a dynamic reading in a static cell, a
    plug-in that gives a reading another check gives, and a rig on a
    static configuration."""
    _cell(root, "tiny-nobody", "tiny-static",
          dict(tiny.limits(False), nobody_gives=0))
    with pytest.raises(ValueError, match="nobody_gives"):
        configio.load_workload("tiny-nobody", root)
    _cell(root, "tiny-static-motion", "tiny-static",
          dict(tiny.limits(False), motion_gap=0))
    with pytest.raises(ValueError, match="motion_gap"):
        configio.load_workload("tiny-static-motion", root)
    _cell(root, "tiny-static-lidar", "tiny-static", tiny.limits(False),
          {"lidar": lidar.HDL64E})
    with pytest.raises(ValueError, match="submit each frame"):
        configio.load_workload("tiny-static-lidar", root)
    cell = configio.load_workload("tiny-eval", root)
    assert set(cell["plugins"]) == {"rows_seen"}
    clash = root / "checks" / "clash.py"
    _write(clash, OVER.replace('"always_one"', '"pose_gap"'))
    try:
        with pytest.raises(ValueError, match="pose_gap"):
            configio.load_workload("tiny-eval", root)
    finally:
        clash.unlink()


def test_committed_cells_are_unchanged():
    """``static-drive``, ``dynamic-traffic`` and the kept
    ``dynamic-empty-road`` load with no plug-in and no rig, and
    ``static-drive`` keeps the folder it had before the hooks; every other
    cell of BENCHMARK.json loads, a rigged one dynamic with a valid rig and
    plug-ins that its limits name."""
    guards.committed_cells_load()


def test_collect_reaches_read(root):
    """A metric file's ``collect`` value is in ``Summary.extra`` under the
    metric's name, where its ``read`` finds it."""
    from types import SimpleNamespace

    from benchmark import trace as tr

    bench = json.loads((root / "BENCHMARK.json").read_text())
    pipe = SimpleNamespace(evaluation=SimpleNamespace(job_ms=[1.0, 2.0, 3.0]))
    got = tr.collect_metrics(bench, "tiny-eval", pipe, range(4, 6), root)
    assert got == {"eval_jobs_seen": {"jobs": 3, "frames": [4, 5]}}
    assert tr.collect_metrics(bench, "tiny-static", pipe, range(1), root) \
        == {}
    events = [dict(name="bench.window", cat="user_annotation", ts=0,
                   dur=100)]
    out = tr.read_metrics(bench, "tiny-eval", tr.Summary(events, 2, got),
                          root)
    assert out["eval_jobs_seen"] == {"value": 3.0, "unit": "jobs"}
