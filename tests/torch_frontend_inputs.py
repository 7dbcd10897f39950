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


# -- the dynamic slice's scene (tests/test_fused_dynamic.py) ---------------

DYN_W, DYN_H, DYN_FRAMES = 160, 120, 6


def dynamic_slice_config(**instance_map):
    """tests/test_dynamic_pipeline.py's ``dynamic_config`` at the KITTI
    layout ``write_kitti_sequence`` gives 160x120 (fx = 0.8 W, baseline
    0.5 m), with ``instance_map`` fields replaced."""
    import dataclasses

    from test_dynamic_pipeline import dynamic_config

    cfg = dynamic_config()
    intr = Intrinsics(0.8 * DYN_W, 0.8 * DYN_W, DYN_W / 2.0, DYN_H / 2.0)
    return dataclasses.replace(
        cfg, frame_width=DYN_W, frame_height=DYN_H, intrinsics=intr,
        right_intrinsics=intr, calibration=StereoCalibration(0.5, intr.fx),
        instance_map=dataclasses.replace(cfg.instance_map, **instance_map))


def make_dynamic_frames(cfg, n=DYN_FRAMES):
    """The frames of ``write_kitti_sequence(with_dynamic=True)``: (left
    gray, right gray, RGB, object ids of the dynamic boxes) each, as the
    sequence's PNGs and segmentation dumps hold them."""
    from dynslam_tpu.io.synthetic import to_uint8_rgb
    from dynslam_tpu.ops import depth as depth_ops

    scene = SyntheticScene.default_scene(with_dynamic=True, seed=0)
    dyn_ids = [i + 1 for i, b in enumerate(scene.boxes) if b.is_dynamic]
    poses = straight_trajectory(n)
    out = []
    for f in range(n):
        fr = render_stereo_frame(scene, poses[f], cfg.intrinsics,
                                 cfg.calibration, cfg.frame_width,
                                 cfg.frame_height, frame=f)
        rgb = to_uint8_rgb(fr["left_gray"])
        right = to_uint8_rgb(fr["right_gray"])
        objid = np.where(np.isin(fr["object_id"], dyn_ids),
                         fr["object_id"], 0)
        out.append((np.asarray(depth_ops.rgb_to_gray(rgb)),
                    np.asarray(depth_ops.rgb_to_gray(right)), rgb, objid))
    return out


def jax_dynamic_sampler(base_key, K: int, cam_iters: int, obj_iters: int):
    """The port's ``sampler`` hook fed with the JAX dynamic step's draws:
    the camera's from ``fold_in(base_key, frame_idx)``, mask j's from
    ``split(fold_in(base_key, frame_idx + 2**20), K)[j]``."""
    import torch

    def sampler(frame_idx, valid):
        v = valid.numpy()
        if v.ndim == 1:
            key = jax.random.fold_in(base_key, frame_idx)
            return torch.tensor(jax_sample_ids(key, v, cam_iters))
        keys = jax.random.split(
            jax.random.fold_in(base_key, frame_idx + (1 << 20)), K)
        return torch.tensor(np.stack([
            jax_sample_ids(keys[j], v[j], obj_iters)
            for j in range(v.shape[0])]))
    return sampler
