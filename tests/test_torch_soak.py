"""The port's soak (``dynslam_tpu_torch/scripts/soak.py``) on the CPU at
160x96: the static and dynamic soaks over 3 laps of a shuttle with the
soak's contract (``check_static``, ``check_dynamic``), at the slice
tests' map and VO sizes (voxel 8 cm, window 80x32x80, 60 RANSAC
hypotheses; the script's own sizes take minutes a lap here); the script's
command line; and, in the slow lane, the JAX package's ``scripts/
soak.py`` beside it on the JAX script's circle at the same size, where
the two reach the same verdict, failure by failure."""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from dynslam_tpu_torch.config import (
    MapParams, SceneParams, StereoMatcherParams, VisualOdometryParams,
)
from dynslam_tpu_torch.scripts import soak
from dynslam_tpu_torch.scripts.bench_setup import render_sets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, LAPS = 160, 96, 3


def failures(msgs):
    """The contract's failures but its frame-rate clause: the frame rates
    of a CPU host shared by the test workers are not the device's (the
    clause is held on the card, ``chip_smoke.py`` phase 18)."""
    return [m for m in msgs if not m.startswith("FPS decayed")]


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small(config, **tracker):
    """The slice tests' map and VO sizes, and ``tracker`` fields."""
    return dataclasses.replace(
        config, max_depth_m=8.0,
        scene=SceneParams(voxel_size_m=0.08, mu_m=0.32),
        map=MapParams(pool_capacity=16384, local_dims=(80, 32, 80),
                      max_new_blocks_per_frame=4096),
        vo=VisualOdometryParams(max_candidates=1024, max_matches=512,
                                ransac_iters=60, max_disparity=64),
        stereo=StereoMatcherParams(max_disparity=64),
        tracker=dataclasses.replace(config.tracker, **tracker))


def test_static_soak(tmp_path):
    """On the dynamic soak's intrinsics, scaled to the size (the static
    soak keeps KITTI's, whose principal point lies below a 96-row
    frame)."""
    lap = 8
    intr, calib = soak.soak_intrinsics(W, H, True)
    cfg = dataclasses.replace(
        small(soak.soak_config(W, H, False, min_decay_age=6)),
        intrinsics=intr, calibration=calib)
    set_, lap_idx = soak.loop_set(lap, W, H, False, "shuttle")
    set_ = set_._replace(intrinsics=intr, calib=calib)
    loop = soak.lap_frames(render_sets([set_], tmp_path)[0], lap_idx)
    res = soak.run_static(cfg, loop, LAPS * lap, "cpu",
                          rng=np.random.default_rng(0), log=lambda m: None)
    assert failures(soak.check_static(cfg, res, LAPS * lap, lap)) == []
    laps = res["laps"]
    assert len(laps) == LAPS and laps[-1]["decayed"] > laps[0]["decayed"]
    assert all(x["used"] > 250 and x["visible"] > 150 for x in laps), laps
    assert all(x["dropped"] == 0 for x in laps)


def test_dynamic_soak(tmp_path):
    """The cars restart every lap: new tracks each lap, slots acquired
    (the track gap exceeds the lap, so a car may keep its slot across
    laps, as with the JAX script's default gap)."""
    lap = 12
    cfg = small(soak.soak_config(W, H, True, min_decay_age=6, track_gap=20,
                                 min_flow=6),
                min_detection_size_px=8, object_ransac_iters=60)
    loop = soak.render_loop(lap, W, H, True, "shuttle", cache_dir=tmp_path)
    res = soak.run_dynamic(cfg, loop, LAPS * lap, "cpu",
                           rng=np.random.default_rng(0), log=lambda m: None)
    assert failures(soak.check_dynamic(cfg, res, lap)) == []
    laps = res["laps"]
    assert min(res["free_series"]) < res["pipe"].S
    assert laps[-1]["tracks_created"] > laps[0]["tracks_created"]
    assert max(x["live_objects"] for x in laps) >= 1


def test_shuttle_lap():
    poses = soak.shuttle_trajectory(6)
    assert np.allclose(poses[:, 2, 3], [0, 0.75, 1.5, 2.25, 1.5, 0.75])
    with pytest.raises(ValueError):
        soak.shuttle_trajectory(5)
    circle = soak.loop_trajectory(150)
    step = np.linalg.norm(circle[1, :3, 3] - circle[0, :3, 3])
    assert abs(step - 2 * np.pi * 18 / 150) < 1e-3


def test_soak_command_line(capsys):
    """A lap of a 4-frame shuttle at 248x75 through ``main``: exit 0
    and the JSON summary line."""
    assert soak.main(["--cpu", "--width", "248", "--height", "75",
                      "--frames", "4", "--loop_frames", "4", "--path",
                      "shuttle", "--pool_capacity", "4096",
                      "--min_decay_age", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["metric"] == "soak_frames"
    assert len(out["laps"]) == 1


def _jax_soak(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_soak", os.path.join(REPO, "scripts", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LOOP_CACHE = str(tmp_path / "loop.npz")
    mod._dyn_cache_path = lambda n, w, h: str(tmp_path / f"dyn{w}x{h}x{n}.npz")
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_soak_verdict_beside_jax(tmp_path, monkeypatch, capsys, dynamic):
    """Both scripts on the JAX script's circle, 3 laps of 12 frames at
    160x96 (the dynamic pair at gap 3 and 6 flow vectors): the same
    verdict and failures. (At this size the dynamic circle turns 30
    degrees a frame, so neither script's tracker keeps a car, and both
    report that no slot was acquired.)"""
    args = ["--cpu", "--width", "160", "--height", "96", "--frames", "36",
            "--loop_frames", "12"]
    if dynamic:
        args += ["--dynamic", "--track_gap", "3", "--min_flow", "6"]
    jsoak = _jax_soak(tmp_path)
    monkeypatch.setattr(sys, "argv", ["soak.py"] + args)
    with pytest.raises(SystemExit) as jexit:
        jsoak.main()
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc = soak.main(args)
    tout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rc == 0) == (jexit.value.code == 0) == tout["ok"] == jout["ok"]
    assert [m.split(":")[0] for m in tout["failures"]] == \
        [m.split(":")[0] for m in jout["failures"]]
