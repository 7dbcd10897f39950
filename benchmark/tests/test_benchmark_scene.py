"""The benchmark's torch renderer against the port's numpy renderer
(``dynslam_tpu_torch/io/synthetic.py``) at a small size: the bench scene
with its three cars and two recurring oncoming ones."""

import numpy as np

from benchmark import scene
from dynslam_tpu_torch.config import Intrinsics, StereoCalibration
from dynslam_tpu_torch.io import synthetic as syn

W, H, N = 160, 120, 4


def test_render_equals_numpy_renderer():
    s = W / 1242
    intr = Intrinsics(707.0912 * s, 707.0912 * s, 601.8873 * s,
                      183.1104 * H / 375)
    calib = StereoCalibration(0.537150654273, intr.fx)
    # default_scene(with_dynamic, n_dynamic=3, recurring_oncoming=2)'s cars
    # in its order: lead, oncoming, slow, then the recurring oncoming ones
    cars = [dict(x=1.2, z=9.0, v=0.85), dict(x=-2.2, z=16.0, v=-0.9),
            dict(x=3.3, z=12.0, v=0.7), dict(x=-2.2, z=44.0, v=-0.9),
            dict(x=-2.2, z=72.0, v=-0.9)]
    drive = scene.make_drive(dict(scene_seed=11, speed_m=0.8, yaw_rate=0.003,
                                  cars=cars), N, n_rows=11)
    gray = scene.render(drive, intr.as_tuple(), calib.baseline_m, W, H,
                        "cpu")
    depth, ids = scene.left_depth_ids(drive, list(range(N)),
                                      intr.as_tuple(), W, H, "cpu")
    want = syn.SyntheticScene.default_scene(
        with_dynamic=True, seed=11, n_dynamic=3, n_rows=11,
        recurring_oncoming=2)
    assert len(want.boxes) == len(drive.centre)
    poses = syn.straight_trajectory(N, speed=0.8, yaw_rate=0.003)
    np.testing.assert_array_equal(drive.poses, poses)
    for f in range(N):
        fr = syn.render_stereo_frame(want, poses[f], intr, calib, W, H,
                                     frame=f)
        for v, key in enumerate(("left_gray", "right_gray")):
            g = np.clip(fr[key] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            np.testing.assert_array_equal(gray[f, v].numpy(), g)
        np.testing.assert_allclose(depth[f], fr["depth_m"], atol=1e-5)
        np.testing.assert_array_equal(ids[f], fr["object_id"])


def test_noise_is_the_seeds():
    g = np.full((3, 2, 8, 8), 128, np.uint8)
    import torch

    a = scene.add_noise(torch.from_numpy(g), 2 ** 31 + 5)
    b = scene.add_noise(torch.from_numpy(g), 2 ** 31 + 5)
    c = scene.add_noise(torch.from_numpy(g), 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int((a.int() - 128).abs().max()) == 1


def test_drive_keeps_cars_coming():
    """Repeated cars: as many copies as meet the camera in the drive."""
    d = scene.make_drive(dict(scene_seed=1, speed_m=0.8, yaw_rate=0.0,
                              cars=[dict(x=-2.2, z=16.0, v=-0.9,
                                         spacing_m=28.0)]), 100)
    assert int(d.dynamic.sum()) == int(100 * 1.7 // 28) + 1
    assert len(d.centre) - int(d.dynamic.sum()) \
        == 2 * int(np.ceil((100 * 0.8 + 80) / 7)) + int(np.ceil(
            (100 * 0.8 + 80) / 7)) // 2
