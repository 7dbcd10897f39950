"""The port's numpy renderer reproduces the JAX package's render path
byte for byte (it is a copy that imports no JAX)."""

import dataclasses

import numpy as np
import pytest

from dynslam_tpu.config import Intrinsics, StereoCalibration
from dynslam_tpu.io import synthetic as jax_synth
from dynslam_tpu_torch import config as port_config
from dynslam_tpu_torch.io import synthetic as port_synth

W, H = 96, 48
INTR = Intrinsics(80.0, 80.0, W / 2.0, H / 2.0)
CALIB = StereoCalibration(0.5, 80.0)


@pytest.mark.parametrize("with_dynamic", [False, True])
def test_render_stereo_frame_identical(with_dynamic):
    pose = jax_synth.straight_trajectory(3, speed=0.6, yaw_rate=0.01)[2]
    assert np.array_equal(
        pose, port_synth.straight_trajectory(3, speed=0.6, yaw_rate=0.01)[2])
    kw = dict(with_dynamic=with_dynamic, seed=5, n_dynamic=2, n_rows=4)
    ref = jax_synth.render_stereo_frame(
        jax_synth.SyntheticScene.default_scene(**kw), pose, INTR, CALIB, W, H,
        frame=2)
    got = port_synth.render_stereo_frame(
        port_synth.SyntheticScene.default_scene(**kw), pose, INTR, CALIB, W,
        H, frame=2)
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k].dtype == got[k].dtype, k
        assert ref[k].tobytes() == got[k].tobytes(), k
    assert np.array_equal(jax_synth.to_uint8_rgb(ref["left_gray"]),
                          port_synth.to_uint8_rgb(got["left_gray"]))


def test_calibration_identical():
    ref = jax_synth.make_calibration(INTR, CALIB)
    got = port_synth.make_calibration(INTR, CALIB)
    for k in ("proj_left_gray", "proj_right_gray", "proj_left_color",
              "proj_right_color", "velo_to_left_cam"):
        a, b = getattr(ref, k), getattr(got, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert got.stereo_calibration() == port_config.StereoCalibration(
        *dataclasses.astuple(ref.stereo_calibration()))


@pytest.mark.parametrize("stride,max_points", [(4, 20000), (2, 1000)])
def test_velodyne_points_identical(stride, max_points):
    """The LIDAR ground truth sampled from a rendered depth map, byte for
    byte, with and without the even thinning to max_points."""
    pose = jax_synth.straight_trajectory(2)[1]
    depth = jax_synth.render_frame(
        jax_synth.SyntheticScene.default_scene(seed=2), pose, INTR, W, H,
        frame=1)["depth_m"]
    v2c = jax_synth.make_calibration(INTR, CALIB).velo_to_left_cam
    ref = jax_synth.make_velodyne_points(depth, INTR, v2c, stride, max_points)
    got = port_synth.make_velodyne_points(depth, INTR, v2c, stride,
                                          max_points)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


def test_calibration_and_scans_round_trip(tmp_path):
    """The port reads what the JAX package writes: calib.txt, poses and a
    velodyne scan."""
    from dynslam_tpu.io import calib as jcalib
    from dynslam_tpu.io import velodyne as jvelo
    from dynslam_tpu_torch.io import calib as tcalib
    from dynslam_tpu_torch.io import velodyne as tvelo

    kc = jax_synth.make_calibration(INTR, CALIB)
    jcalib.write_kitti_calibration(str(tmp_path / "calib.txt"), kc)
    got = tcalib.read_kitti_calibration(str(tmp_path / "calib.txt"))
    ref = jcalib.read_kitti_calibration(str(tmp_path / "calib.txt"))
    for k in ("proj_left_color", "proj_right_color", "velo_to_left_cam"):
        assert np.array_equal(getattr(got, k), getattr(ref, k)), k
    tcalib.write_kitti_calibration(str(tmp_path / "c2.txt"), got)
    assert (tmp_path / "c2.txt").read_bytes() == \
        (tmp_path / "calib.txt").read_bytes()
    poses = jax_synth.straight_trajectory(3)
    jcalib.write_kitti_poses(str(tmp_path / "p.txt"), poses)
    assert np.array_equal(tcalib.read_kitti_poses(str(tmp_path / "p.txt")),
                          jcalib.read_kitti_poses(str(tmp_path / "p.txt")))
    pts = np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32)
    jvelo.write_frame(str(tmp_path / "v" / "000000.bin"), pts)
    io = tvelo.VelodyneIO(str(tmp_path / "v"))
    assert io.frame_available(0) and not io.frame_available(1)
    assert np.array_equal(io.read_frame(0), pts)
