"""ICP depth tracking (the static step's VO fallback): the port against
``dynslam_tpu/ops/icp.py`` on the same depth maps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.io.synthetic import SyntheticScene
from dynslam_tpu.ops import icp as ji
from dynslam_tpu_torch.ops import icp as ti

from torch_frontend_inputs import H, INTR, W, make_frames
from torch_threads import threads

torch_threads = threads(2)


@pytest.fixture(scope="module")
def frames():
    return make_frames()


def test_icp_matches_jax(frames):
    """Track frame 1's ground-truth depth against frame 0's depth as the
    reference render, from a perturbed start."""
    from dynslam_tpu.io.synthetic import render_frame

    _, poses = frames
    scene = SyntheticScene.default_scene(seed=3)
    d0 = render_frame(scene, poses[0], INTR, W, H, supersample=1)["depth_m"]
    d1 = render_frame(scene, poses[1], INTR, W, H, supersample=1)["depth_m"]
    d0 = np.where(d0 < 20, d0, 0).astype(np.float32)
    d1 = np.where(d1 < 20, d1, 0).astype(np.float32)
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float32)
    pc = np.stack([(uu - INTR.cx) / INTR.fx * d0,
                   (vv - INTR.cy) / INTR.fy * d0, d0], -1)
    c2w0 = poses[0].astype(np.float32)
    pts = (pc @ c2w0[:3, :3].T + c2w0[:3, 3]).astype(np.float32)
    hit = d0 > 0
    w2c0 = np.linalg.inv(c2w0).astype(np.float32)
    w2c1 = np.linalg.inv(poses[1]).astype(np.float32)
    init = w2c0.copy()
    init[:3, 3] += [0.02, -0.01, 0.05]
    intr = np.asarray([INTR.fx, INTR.fy, INTR.cx, INTR.cy], np.float32)
    rj = ji.icp_track(*map(jnp.asarray, (d1, pts, hit, w2c0, init, intr)))
    rt = ti.icp_track(*map(torch.tensor, (d1, pts, hit, w2c0, init, intr)))
    assert bool(rj.success) and bool(rt.success)
    assert abs(int(rj.num_inliers) - int(rt.num_inliers)) <= 2
    assert np.abs(np.asarray(rj.world_to_cam)
                  - rt.world_to_cam.numpy()).max() <= 1e-4
    assert np.abs(rt.world_to_cam.numpy() - w2c1).max() < 0.02
