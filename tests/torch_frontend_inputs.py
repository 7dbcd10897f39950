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


def write_eval_sequence(root, cfg, n: int, dynamic: bool):
    """``n`` frames of the ``write_kitti_sequence`` scene at ``cfg``'s size,
    with what the evaluation reads written under ``root`` in the KITTI
    odometry layout: ``calib.txt`` and a LIDAR scan a frame
    (``make_velodyne_points``). Returns [(left gray, right gray, RGB,
    object ids of the dynamic boxes)] as ``make_dynamic_frames``."""
    import os

    from dynslam_tpu.io import velodyne
    from dynslam_tpu.io.calib import write_kitti_calibration
    from dynslam_tpu.io.synthetic import (
        make_calibration, make_velodyne_points, to_uint8_rgb,
    )
    from dynslam_tpu.ops import depth as depth_ops

    scene = SyntheticScene.default_scene(with_dynamic=dynamic, seed=0)
    dyn_ids = [i + 1 for i, b in enumerate(scene.boxes) if b.is_dynamic]
    kcal = make_calibration(cfg.intrinsics, cfg.calibration)
    os.makedirs(root, exist_ok=True)
    write_kitti_calibration(os.path.join(root, "calib.txt"), kcal)
    poses = straight_trajectory(n)
    out = []
    for f in range(n):
        fr = render_stereo_frame(scene, poses[f], cfg.intrinsics,
                                 cfg.calibration, cfg.frame_width,
                                 cfg.frame_height, frame=f)
        velodyne.write_frame(
            os.path.join(root, "velodyne", f"{f:06d}.bin"),
            make_velodyne_points(fr["depth_m"], cfg.intrinsics,
                                 kcal.velo_to_left_cam))
        rgb = to_uint8_rgb(fr["left_gray"])
        right = to_uint8_rgb(fr["right_gray"])
        objid = np.where(np.isin(fr["object_id"], dyn_ids),
                         fr["object_id"], 0)
        out.append((np.asarray(depth_ops.rgb_to_gray(rgb)),
                    np.asarray(depth_ops.rgb_to_gray(right)), rgb, objid))
    return out


def jax_fused_evaluation(root, cfg, csv_dir):
    """The JAX package's ``FusedEvaluation`` of ``root`` as its
    ``build_fused(with_evaluation=True)`` attaches it."""
    import os

    from dynslam_tpu.eval.fused_eval import FusedEvaluation
    from dynslam_tpu.io.calib import read_kitti_calibration
    from dynslam_tpu.io.depth_providers import InGraphDepthProvider
    from dynslam_tpu.io.input import Input, kitti_odometry_config

    icfg = kitti_odometry_config()
    inp = Input(root, icfg, InGraphDepthProvider(),
                (cfg.frame_width, cfg.frame_height), cfg.calibration)
    return FusedEvaluation(
        root, icfg, inp, read_kitti_calibration(os.path.join(root,
                                                             "calib.txt")),
        cfg, csv_out_dir=csv_dir)


#: candidate blocks a tile of the JAX package's Pallas raycast keeps in
#: the slice tests: more than any tile of their scenes holds (at most 120)
RENDER_CAND_K = 256
#: each render's largest per-tile candidate count (``jax_kernel_renders``);
#: one list for the process, as a jitted step traced by an earlier test
#: calls the callback it was traced with
_CAND_FILL: list = []


def jax_kernel_renders(mp) -> list:
    """Make a JAX pipeline built with ``use_pallas=True`` run on the CPU
    with the port's render rule, ``mp`` a ``pytest.MonkeyPatch``:

    - the Pallas raycast in interpret mode (its own tests' way), with
      per-tile candidate lists of ``RENDER_CAND_K`` blocks; the port's K2
      is its translation with an uncapped candidate bitmap, so the two
      agree where no tile's list overflows;
    - the XLA fusion ``tsdf.integrate`` in place of the Pallas fusion (the
      rule the port's plain K1 is held to).

    Returns a list, emptied here, that gets each render's largest
    per-tile candidate count: a test asserts they stay under
    ``RENDER_CAND_K``. (The CPU
    path's dense XLA raycast is another rule, and the default 64
    candidates drop far blocks from crowded tiles: either leaves a few
    percent of the evaluated points on the other side of a threshold.)"""
    import dataclasses

    import dynslam_tpu.ops.pallas_integrate as jpi
    import dynslam_tpu.ops.pallas_raycast as jpr
    from dynslam_tpu.ops import tsdf

    def integrate(cfg, state, slots, mask, rgb, depth, w2c, fidx,
                  intr4=None):
        return tsdf.integrate(cfg, state, slots, mask, rgb, depth, w2c,
                              fidx, intr4=intr4)

    fill = _CAND_FILL
    fill.clear()
    build, tiled = jpr.build_candidates, jpr.raycast_tiled

    def candidates(*args, **kw):
        out = build(*args, **kw)
        jax.debug.callback(lambda n: fill.append(int(n)), out[-1].max())
        return out

    def raycast(cfg, *args, **kw):
        return tiled(dataclasses.replace(cfg, raycast_cand_k=RENDER_CAND_K),
                     *args, interpret=True, **kw)

    mp.setattr(jpi, "integrate_pallas", integrate)
    mp.setattr(jpr, "build_candidates", candidates)
    mp.setattr(jpr, "raycast_tiled", raycast)
    return fill


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
