"""Synthetic stereo scenes, rendered analytically with numpy.

A numpy-only copy of the render path of ``dynslam_tpu/io/synthetic.py``
(``Box``, ``SyntheticScene``, ``_texture``, ``_ray_scene_intersect``,
``render_frame``, ``render_stereo_frame``, ``straight_trajectory``,
``to_uint8_rgb``), of the LIDAR ground truth (``make_calibration``,
``make_velodyne_points``) and of the KITTI-layout writer
(``write_kitti_sequence``, with ``write_kitti_frame`` for frames rendered
elsewhere), which writes through the port's own PNG, XML and PFM writers.
This copy imports nothing of the JAX package, so the port renders and
writes scenes on a machine without JAX or OpenCV. ``tests/test_torch_synthetic.py`` pins its images to the JAX
package's copy byte for byte.

Camera convention: KITTI camera frame (x right, y down, z forward);
world frame = camera frame of frame 0. Ground plane at y = +1.65.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from dynslam_tpu_torch.config import Intrinsics, StereoCalibration
from dynslam_tpu_torch.io.calib import KittiCalibration


@dataclass
class Box:
    """Axis-aligned box in its own object frame, with a world pose."""

    half_extents: np.ndarray  # (3,)
    pose: np.ndarray  # 4x4 object-to-world
    #: per-frame velocity (world units/frame); moving boxes get per-frame poses
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))
    is_dynamic: bool = False

    def pose_at(self, frame: int) -> np.ndarray:
        T = self.pose.copy()
        T[:3, 3] = T[:3, 3] + self.velocity * frame
        return T


@dataclass
class SyntheticScene:
    ground_y: float = 1.65
    boxes: List[Box] = field(default_factory=list)
    max_range: float = 80.0

    @staticmethod
    def default_scene(with_dynamic: bool = False, seed: int = 0,
                      n_dynamic: int = 1, n_rows: int = 6,
                      recurring_oncoming: int = 0) -> "SyntheticScene":
        """`n_rows` building rows (7 m spacing) set the corridor length a
        straight trajectory can traverse with texture in view;
        `recurring_oncoming` appends that many extra oncoming cars spaced
        28 m behind the first so one passes the camera every ~16 frames
        on a long run (KITTI-like traffic cadence)."""
        rng = np.random.default_rng(seed)
        boxes = []
        # "buildings": rows of boxes flanking a corridor along +z
        for side in (-1.0, 1.0):
            for i in range(n_rows):
                z = 4.0 + i * 7.0 + rng.uniform(-1, 1)
                x = side * (4.5 + rng.uniform(0, 2.0))
                h = rng.uniform(2.0, 4.0)
                w = rng.uniform(1.0, 2.5)
                d = rng.uniform(1.5, 3.0)
                pose = np.eye(4)
                pose[:3, 3] = [x, 1.65 - h / 2.0, z]
                boxes.append(Box(np.array([w / 2, h / 2, d / 2]), pose))
        # a few low obstacles in the corridor
        for i in range(max(3, n_rows // 2)):
            pose = np.eye(4)
            pose[:3, 3] = [rng.uniform(-2, 2), 1.65 - 0.4, 12.0 + i * 12.0]
            boxes.append(Box(np.array([0.6, 0.4, 0.9]), pose))
        if with_dynamic:
            # a "car" driving ahead of the camera, slightly to the right
            pose = np.eye(4)
            pose[:3, 3] = [1.2, 1.65 - 0.75, 9.0]
            boxes.append(
                Box(
                    np.array([0.9, 0.75, 2.1]),
                    pose,
                    # 0.85 m/frame ~ 30 km/h at 10 fps: safely above the
                    # 0.55 m dynamic threshold (Track.h:90-98)
                    velocity=np.array([0.0, 0.0, 0.85]),
                    is_dynamic=True,
                )
            )
            if n_dynamic >= 2:
                # oncoming car in the opposite lane
                pose2 = np.eye(4)
                pose2[:3, 3] = [-2.2, 1.65 - 0.75, 16.0]
                boxes.append(
                    Box(
                        np.array([0.9, 0.75, 2.1]),
                        pose2,
                        velocity=np.array([0.0, 0.0, -0.9]),
                        is_dynamic=True,
                    )
                )
            if n_dynamic >= 3:
                # slower lead car in the outer right lane
                pose3 = np.eye(4)
                pose3[:3, 3] = [3.3, 1.65 - 0.75, 12.0]
                boxes.append(
                    Box(
                        np.array([0.9, 0.75, 2.1]),
                        pose3,
                        velocity=np.array([0.0, 0.0, 0.7]),
                        is_dynamic=True,
                    )
                )
            if n_dynamic >= 4:
                # second oncoming car in the outer left lane
                pose4 = np.eye(4)
                pose4[:3, 3] = [-3.4, 1.65 - 0.75, 14.0]
                boxes.append(
                    Box(
                        np.array([0.9, 0.75, 2.1]),
                        pose4,
                        velocity=np.array([0.0, 0.0, -0.75]),
                        is_dynamic=True,
                    )
                )
            for j in range(recurring_oncoming):
                posej = np.eye(4)
                posej[:3, 3] = [-2.2, 1.65 - 0.75, 16.0 + 28.0 * (j + 1)]
                boxes.append(
                    Box(
                        np.array([0.9, 0.75, 2.1]),
                        posej,
                        velocity=np.array([0.0, 0.0, -0.9]),
                        is_dynamic=True,
                    )
                )
        return SyntheticScene(boxes=boxes)


def _texture(points: np.ndarray, rng_salt: int = 0) -> np.ndarray:
    """View-independent procedural albedo in [0,1] from world coords.

    Mixes smooth sinusoidal octaves (gradients for subpixel refinement)
    with hashed cell speckle (corners for feature detection)."""
    p = points
    smooth = (
        0.5
        + 0.25 * np.sin(3.1 * p[..., 0]) * np.sin(2.3 * p[..., 2])
        + 0.15 * np.sin(7.7 * p[..., 1] + 1.3 * p[..., 2])
        + 0.10 * np.sin(13.7 * p[..., 0] + 5.1 * p[..., 1])
    )
    cells = np.floor(p * 3.7).astype(np.int64)
    h = (
        cells[..., 0] * 73856093
        ^ cells[..., 1] * 19349663
        ^ cells[..., 2] * 83492791
        ^ np.int64(rng_salt)
    )
    speckle = ((h & 0xFFFF) / 65535.0 - 0.5) * 0.5
    return np.clip(smooth + speckle, 0.02, 1.0)


def _ray_scene_intersect(
    origins: np.ndarray, dirs: np.ndarray, scene: SyntheticScene, frame: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch ray cast. origins (3,), dirs (..., 3) world-frame.

    Returns (t, hit_points, object_id): t = inf where no hit;
    object_id -1 = none, 0 = ground, i+1 = scene.boxes[i]."""
    shape = dirs.shape[:-1]
    t_best = np.full(shape, np.inf)
    obj_id = np.full(shape, -1, dtype=np.int32)

    # ground plane y = ground_y
    dy = dirs[..., 1]
    t_plane = np.where(
        np.abs(dy) > 1e-9, (scene.ground_y - origins[1]) / np.where(np.abs(dy) > 1e-9, dy, 1.0), np.inf
    )
    hit = (t_plane > 0.1) & (t_plane < scene.max_range)
    t_best = np.where(hit, t_plane, t_best)
    obj_id = np.where(hit, 0, obj_id)

    for i, box in enumerate(scene.boxes):
        T = box.pose_at(frame)
        R, t0 = T[:3, :3], T[:3, 3]
        # transform ray to object frame
        o_loc = R.T @ (origins - t0)
        d_loc = dirs @ R  # (R.T @ d) for each row
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_d = 1.0 / np.where(np.abs(d_loc) < 1e-12, 1e-12, d_loc)
        t1 = (-box.half_extents - o_loc) * inv_d
        t2 = (box.half_extents - o_loc) * inv_d
        t_near = np.minimum(t1, t2).max(axis=-1)
        t_far = np.maximum(t1, t2).min(axis=-1)
        t_hit = np.where((t_near <= t_far) & (t_far > 0.1), np.maximum(t_near, 0.1), np.inf)
        better = t_hit < t_best
        t_best = np.where(better, t_hit, t_best)
        obj_id = np.where(better, i + 1, obj_id)

    with np.errstate(invalid="ignore"):
        pts = origins + dirs * t_best[..., None]
    return t_best, pts, obj_id


def render_frame(
    scene: SyntheticScene,
    cam_to_world: np.ndarray,
    intrinsics: Intrinsics,
    width: int,
    height: int,
    frame: int = 0,
    texture_salt: int = 0,
    supersample: int = 2,
) -> dict:
    """Render one camera view. Returns dict with:
    gray (H,W) float in [0,1], depth_m (H,W) z-depth (inf = sky),
    object_id (H,W) int32.

    The image is rendered `supersample`x oversampled and box-averaged —
    without pixel-area integration, grazing-angle surfaces (the road)
    alias badly and bias sub-pixel matching, which real cameras don't do.
    Depth/object ids stay point-sampled at pixel centers (exact GT)."""
    if supersample > 1:
        s = supersample
        # sub-pixel grid centered on the original pixel centers
        hi_intr = Intrinsics(
            intrinsics.fx * s, intrinsics.fy * s,
            intrinsics.cx * s + (s - 1) / 2.0,
            intrinsics.cy * s + (s - 1) / 2.0,
        )
        hi = render_frame(
            scene, cam_to_world, hi_intr, width * s, height * s,
            frame, texture_salt, supersample=1,
        )
        gray = hi["gray"].reshape(height, s, width, s).mean(axis=(1, 3))
        lo = render_frame(
            scene, cam_to_world, intrinsics, width, height,
            frame, texture_salt, supersample=1,
        )
        return {"gray": gray, "depth_m": lo["depth_m"], "object_id": lo["object_id"]}

    fx, fy, cx, cy = intrinsics.as_tuple()
    u = np.arange(width, dtype=np.float64)
    v = np.arange(height, dtype=np.float64)
    uu, vv = np.meshgrid(u, v)
    rays_cam = np.stack(
        [(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], axis=-1
    )
    R, t = cam_to_world[:3, :3], cam_to_world[:3, 3]
    rays_world = rays_cam @ R.T
    t_hit, pts, obj_id = _ray_scene_intersect(t, rays_world, scene, frame)

    # z-depth in camera frame = t_hit * rays_cam_z = t_hit (rays_cam z == 1)
    depth_m = np.where(np.isfinite(t_hit), t_hit, 0.0)

    # texture in object frame for dynamic boxes so it moves with them
    tex_pts = np.where(np.isfinite(pts), pts, 0.0)
    for i, box in enumerate(scene.boxes):
        if box.is_dynamic:
            sel = obj_id == i + 1
            if sel.any():
                T = box.pose_at(frame)
                local = (pts[sel] - T[:3, 3]) @ T[:3, :3]
                tex_pts[sel] = local
    gray = _texture(tex_pts, texture_salt)
    gray = np.where(np.isfinite(t_hit), gray, 0.08)  # dark sky

    # simple distance shading for realism
    shade = np.clip(1.0 - depth_m / (scene.max_range * 1.5), 0.4, 1.0)
    gray = gray * np.where(depth_m > 0, shade, 1.0)
    return {"gray": gray, "depth_m": depth_m, "object_id": obj_id}


def render_stereo_frame(
    scene: SyntheticScene,
    cam_to_world: np.ndarray,
    intrinsics: Intrinsics,
    calib: StereoCalibration,
    width: int,
    height: int,
    frame: int = 0,
) -> dict:
    """Render a photo-consistent stereo pair. The right camera is the left
    pose translated +baseline along camera x."""
    left = render_frame(scene, cam_to_world, intrinsics, width, height, frame)
    right_pose = cam_to_world.copy()
    right_pose[:3, 3] = right_pose[:3, 3] + cam_to_world[:3, 0] * calib.baseline_m
    right = render_frame(scene, right_pose, intrinsics, width, height, frame)

    disparity = np.where(
        left["depth_m"] > 0, calib.bf / np.maximum(left["depth_m"], 1e-6), 0.0
    )
    return {
        "left_gray": left["gray"],
        "right_gray": right["gray"],
        "depth_m": left["depth_m"],
        "disparity": disparity.astype(np.float32),
        "object_id": left["object_id"],
    }


def straight_trajectory(
    num_frames: int, speed: float = 0.35, yaw_rate: float = 0.002
) -> np.ndarray:
    """(N,4,4) cam-to-world poses: forward motion with gentle yaw."""
    poses = np.zeros((num_frames, 4, 4))
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(num_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses[i] = T
        pos = pos + R @ np.array([0.0, 0.0, speed])
        yaw += yaw_rate
    return poses


def to_uint8_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(gray * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def make_calibration(
    intrinsics: Intrinsics, calib: StereoCalibration
) -> KittiCalibration:
    """KITTI-style projection matrices of the synthetic rig. Velodyne
    frame: KITTI's (x forward, z up), 5 cm from the camera."""
    K = np.array(
        [
            [intrinsics.fx, 0, intrinsics.cx, 0],
            [0, intrinsics.fy, intrinsics.cy, 0],
            [0, 0, 1, 0],
        ]
    )
    P_right = K.copy()
    P_right[0, 3] = -intrinsics.fx * calib.baseline_m
    # velo -> cam: velo x->cam z, velo y->cam -x, velo z->cam -y
    velo_to_cam = np.array(
        [
            [0, -1, 0, 0],
            [0, 0, -1, -0.05],
            [1, 0, 0, 0.05],
            [0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    return KittiCalibration(
        proj_left_gray=K,
        proj_right_gray=P_right,
        proj_left_color=K,
        proj_right_color=P_right.copy(),
        velo_to_left_cam=velo_to_cam,
    )


def make_velodyne_points(
    depth_m: np.ndarray,
    intrinsics: Intrinsics,
    velo_to_cam: np.ndarray,
    stride: int = 4,
    max_points: int = 20000,
) -> np.ndarray:
    """LIDAR-like points sampled from the rendered depth (exact ground
    truth) every ``stride`` pixels, in the velodyne frame, (N, 4) float32
    with constant reflectance; evenly thinned to ``max_points``."""
    h, w = depth_m.shape
    fx, fy, cx, cy = intrinsics.as_tuple()
    vv, uu = np.mgrid[0:h:stride, 0:w:stride]
    z = depth_m[::stride, ::stride]
    valid = z > 0
    u, v, z = uu[valid], vv[valid], z[valid]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts_cam = np.stack([x, y, z, np.ones_like(z)], axis=-1)
    cam_to_velo = np.linalg.inv(velo_to_cam)
    pts_velo = pts_cam @ cam_to_velo.T
    pts_velo[:, 3] = 0.5  # reflectance
    if len(pts_velo) > max_points:
        idx = np.linspace(0, len(pts_velo) - 1, max_points).astype(int)
        pts_velo = pts_velo[idx]
    return pts_velo.astype(np.float32)


def write_kitti_frame(root: str, frame: int, left_rgb: np.ndarray,
                      right_rgb: np.ndarray, depth_m: np.ndarray,
                      object_masks=None, disparity=None,
                      velodyne_points=None,
                      write_elas_xml: bool = True) -> None:
    """One frame of a KITTI-odometry folder under ``root``: the colour
    pair (``image_2``/``image_3`` PNGs), the ELAS depth dump
    (``precomputed-depth/Frames``, mm clamped to 0.5-20 m), DispNet
    disparity (``.pfm``) and LIDAR when given, and, when
    ``object_masks`` is a list (full-frame bool masks of the dynamic
    objects), the MNC dump of those with at least 16 pixels (score 0.98,
    VOC class 7 "car")."""
    import os

    from dynslam_tpu_torch.io import velodyne
    from dynslam_tpu_torch.io.images import write_opencv_xml, write_png
    from dynslam_tpu_torch.io.segmentation import BoundingBox, write_mnc_dump
    from dynslam_tpu_torch.utils.pfm import write_pfm

    write_png(os.path.join(root, "image_2", f"{frame:06d}.png"), left_rgb)
    write_png(os.path.join(root, "image_3", f"{frame:06d}.png"), right_rgb)
    if write_elas_xml:
        depth_mm = np.clip(depth_m * 1000.0, 0, 32767)
        depth_mm = np.where((depth_m >= 0.5) & (depth_m <= 20.0), depth_mm,
                            0).astype(np.int16)
        write_opencv_xml(os.path.join(root, "precomputed-depth/Frames",
                                      f"{frame:04d}.xml"), "depth", depth_mm)
    if disparity is not None:
        write_pfm(os.path.join(root, "precomputed-depth-dispnet",
                               f"{frame:06d}.pfm"), disparity)
    if velodyne_points is not None:
        velodyne.write_frame(os.path.join(root, "velodyne",
                                          f"{frame:06d}.bin"),
                             velodyne_points)
    if object_masks is not None:
        dets = []
        for mask in object_masks:
            if mask.sum() < 16:
                continue
            ys, xs = np.nonzero(mask)
            bbox = BoundingBox(int(xs.min()), int(ys.min()), int(xs.max()),
                               int(ys.max()))
            sub = mask[bbox.y0: bbox.y1 + 1, bbox.x0: bbox.x1 + 1]
            dets.append((bbox, 0.98, 7, sub.astype(np.uint8)))
        write_mnc_dump(os.path.join(root, "seg_image_2/mnc"), frame, dets)


def tracklet_lines(scene: SyntheticScene, frame: int, c2w: np.ndarray,
                   masks) -> List[str]:
    """KITTI tracking-format labels (``io/tracklets.py``) of the dynamic
    boxes in frame ``frame``, seen from camera pose ``c2w``: ``masks``
    pairs a box's index in ``scene.boxes`` with its full-frame mask; boxes
    of fewer than 16 pixels are left out."""
    w2c = np.linalg.inv(c2w)
    lines = []
    for i, m in masks:
        if m.sum() < 16:
            continue
        ys, xs = np.nonzero(m)
        box = scene.boxes[i]
        loc = w2c[:3, :3] @ box.pose_at(frame)[:3, 3] + w2c[:3, 3]
        he = box.half_extents
        lines.append(
            f"{frame} {i} Car 0 0 0.0 {xs.min()} {ys.min()} {xs.max()} "
            f"{ys.max()} {2 * he[1]:.3f} {2 * he[0]:.3f} "
            f"{2 * he[2]:.3f} {loc[0]:.4f} {loc[1]:.4f} {loc[2]:.4f} 0.0")
    return lines


def write_kitti_frames(root: str, scene: SyntheticScene, poses: np.ndarray,
                       kcal, frames, with_dynamic: bool = False,
                       write_elas_xml: bool = True) -> None:
    """Write rendered frames of ``scene`` as a KITTI-odometry folder under
    ``root`` (folders per Input.h:61-86): ``calib.txt`` from ``kcal``,
    the camera ``poses``, and for frame f of ``frames`` its files
    (``write_kitti_frame``) and tracklet lines. Each frame is a dict of
    ``left``/``right`` (uint8 RGB), ``depth_m``, ``object_id`` (the
    renderer's ids) and, where written, ``disparity`` and ``velodyne``."""
    import os

    from dynslam_tpu_torch.io.calib import (
        write_kitti_calibration, write_kitti_poses,
    )

    for sub in ("image_2", "image_3", "velodyne", "precomputed-depth/Frames",
                "precomputed-depth-dispnet", "seg_image_2/mnc"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    write_kitti_calibration(os.path.join(root, "calib.txt"), kcal)
    write_kitti_poses(os.path.join(root, "ground-truth-poses.txt"), poses)
    tracklet_path = os.path.join(root, "tracklets.txt")
    if os.path.exists(tracklet_path):
        os.remove(tracklet_path)
    dyn = [i for i, box in enumerate(scene.boxes) if box.is_dynamic]
    for f, fr in enumerate(frames):
        masks = [fr["object_id"] == i + 1 for i in dyn]
        write_kitti_frame(
            root, f, fr["left"], fr["right"], fr["depth_m"],
            object_masks=masks if (with_dynamic or any(
                m.sum() >= 16 for m in masks)) else None,
            disparity=fr.get("disparity"),
            velodyne_points=fr.get("velodyne"),
            write_elas_xml=write_elas_xml)
        lines = tracklet_lines(scene, f, poses[f], zip(dyn, masks))
        if lines:
            with open(tracklet_path, "a") as tf:
                tf.write("\n".join(lines) + "\n")


def write_kitti_sequence(
    root: str,
    num_frames: int = 10,
    width: int = 128,
    height: int = 96,
    intrinsics=None,
    calib=None,
    with_dynamic: bool = False,
    n_dynamic: int = 1,
    write_velodyne: bool = True,
    write_dispnet: bool = False,
    write_elas_xml: bool = True,
    seed: int = 0,
    scene_kwargs=None,
    trajectory_kwargs=None,
) -> SyntheticScene:
    """Render a synthetic sequence into the KITTI-odometry layout under
    ``root`` (``write_kitti_frames``), as the JAX package's
    ``write_kitti_sequence`` does, with the port's own PNG, XML and PFM
    writers. Returns the scene for ground-truth checks."""
    if intrinsics is None:
        intrinsics = Intrinsics(fx=0.8 * width, fy=0.8 * width,
                                cx=width / 2.0, cy=height / 2.0)
    if calib is None:
        calib = StereoCalibration(baseline_m=0.5,
                                  focal_length_px=intrinsics.fx)
    scene = SyntheticScene.default_scene(with_dynamic=with_dynamic, seed=seed,
                                         n_dynamic=n_dynamic,
                                         **(scene_kwargs or {}))
    poses = straight_trajectory(num_frames, **(trajectory_kwargs or {}))
    kcal = make_calibration(intrinsics, calib)

    def rendered():
        for f in range(num_frames):
            fr = render_stereo_frame(scene, poses[f], intrinsics, calib,
                                     width, height, frame=f)
            yield dict(
                left=to_uint8_rgb(fr["left_gray"]),
                right=to_uint8_rgb(fr["right_gray"]),
                depth_m=fr["depth_m"], object_id=fr["object_id"],
                disparity=fr["disparity"] if write_dispnet else None,
                velodyne=make_velodyne_points(
                    fr["depth_m"], intrinsics, kcal.velo_to_left_cam)
                if write_velodyne else None)

    write_kitti_frames(root, scene, poses, kcal, rendered(), with_dynamic,
                       write_elas_xml)
    return scene
