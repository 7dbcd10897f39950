"""Shared inputs of the front-end parity tests (tests/test_torch_*.py):
two stereo frames of the tests/test_fused.py scene and JAX's RANSAC
draws."""

import jax
import jax.numpy as jnp
import numpy as np

from dynslam_tpu.config import (
    Intrinsics, StereoCalibration, VisualOdometryParams,
)
from dynslam_tpu.io.synthetic import (
    SyntheticScene, render_stereo_frame, straight_trajectory,
)

W, H = 192, 96
INTR = Intrinsics(160.0, 160.0, W / 2.0, H / 2.0)
CALIB = StereoCalibration(0.5, 160.0)
VO = VisualOdometryParams(max_candidates=1024, max_matches=512,
                          ransac_iters=60, max_disparity=64)


def make_frames():
    """Two stereo frames of the tests/test_fused.py scene (uint8-valued
    float gray) and their ground-truth cam-to-world poses."""
    scene = SyntheticScene.default_scene(seed=3)
    poses = straight_trajectory(2, speed=0.5, yaw_rate=0.004)
    out = []
    for i in range(2):
        fr = render_stereo_frame(scene, poses[i], INTR, CALIB, W, H, frame=i)
        out.append(tuple(np.clip(fr[k] * 255, 0, 255).astype(np.float32)
                         for k in ("left_gray", "right_gray")))
    return out, poses


def jax_sample_ids(key, valid: np.ndarray, iters: int) -> np.ndarray:
    """The RANSAC draws of ``egomotion.estimate_motion`` (Gumbel top-3 per
    hypothesis, egomotion.py:142-157), reproduced from the same key."""
    n = valid.shape[0]
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)

    def one(k):
        g = jax.random.gumbel(k, (n,)) + logits
        lane = jax.lax.iota(jnp.int32, n)
        ids = []
        for _ in range(3):
            i = jnp.argmax(g)
            ids.append(i)
            g = jnp.where(lane == i, -jnp.inf, g)
        return jnp.stack(ids)

    return np.asarray(jax.vmap(one)(jax.random.split(key, iters)))
