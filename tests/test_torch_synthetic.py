"""The port's numpy renderer reproduces the JAX package's render path
byte for byte (it is a copy that imports no JAX)."""

import numpy as np
import pytest

from dynslam_tpu.config import Intrinsics, StereoCalibration
from dynslam_tpu.io import synthetic as jax_synth
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
