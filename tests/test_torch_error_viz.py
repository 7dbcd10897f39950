"""The port's LIDAR error overlay (``eval/error_viz.py``) against the JAX
package's on the same inputs: byte-identical (both are host numpy in the
same dtypes). The scene: a synthetic frame's exact depth, its LIDAR scan
(``make_velodyne_points``) and calibration, with a hole (blue splats) and
a band 30% too deep (red splats) cut into the evaluated depth."""

import numpy as np
import pytest

from dynslam_tpu.config import Intrinsics, StereoCalibration
from dynslam_tpu.eval.error_viz import render_depth_error as jax_overlay
from dynslam_tpu.io.synthetic import (
    SyntheticScene, make_calibration, make_velodyne_points, render_frame,
    to_uint8_rgb,
)
from dynslam_tpu_torch.eval.error_viz import (
    ERROR, GOOD, MISSING, render_depth_error,
)

W, H = 160, 120
INTR = Intrinsics(128.0, 128.0, W / 2, H / 2)
CALIB = StereoCalibration(0.5, 128.0)


@pytest.fixture(scope="module")
def inputs():
    scene = SyntheticScene.default_scene(seed=2)
    fr = render_frame(scene, np.eye(4), INTR, W, H)
    kcal = make_calibration(INTR, CALIB)
    lidar = make_velodyne_points(fr["depth_m"], INTR, kcal.velo_to_left_cam)
    depth = fr["depth_m"].astype(np.float32).copy()
    depth[:, : W // 5] = 0.0  # no depth: blue
    depth[H // 2:, W // 2:] *= 1.3  # too deep: red
    return dict(lidar=lidar, depth=depth,
                rgb=to_uint8_rgb(fr["gray"]), kcal=kcal)


@pytest.mark.parametrize("splat,delta_max", [(1, 3.0), (0, 3.0), (2, 1.0)])
def test_overlay_byte_identical(inputs, splat, delta_max):
    k = inputs["kcal"]
    args = (inputs["lidar"], inputs["depth"], inputs["rgb"],
            k.velo_to_left_cam, k.proj_left_color, k.proj_right_color,
            CALIB.bf)
    want = jax_overlay(*args, delta_max=delta_max, splat=splat)
    got = render_depth_error(*args, delta_max=delta_max, splat=splat)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert np.array_equal(want, got)
    assert got.tobytes() == want.tobytes()
    # all three kinds of splat are there
    for colour in (GOOD, ERROR, MISSING):
        assert (got == colour).all(-1).sum() > 20, colour
