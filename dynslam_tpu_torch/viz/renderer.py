"""Headless map renders — the port of ``dynslam_tpu/viz/renderer.py``, in
place of the reference's Pangolin free camera (the DSHandler3D yaw/pitch
handler) and chase camera (DynSLAMGUI.cpp): orbit turntables around a
point of interest and chase-camera sequences along the trajectory,
written as PNGs. Every render is K2 at a full-frame free pose
(``MapEngine.get_image``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from dynslam_tpu_torch.io.images import write_png
from dynslam_tpu_torch.pipeline.mapping import MapEngine, PreviewType


def look_at(eye: np.ndarray, target: np.ndarray,
            up=np.array([0.0, -1.0, 0.0])) -> np.ndarray:
    """Cam-to-world matrix looking from ``eye`` at ``target`` (KITTI
    frame: y points down, hence the default up vector)."""
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right) + 1e-9
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0] = right
    T[:3, 1] = down
    T[:3, 2] = fwd
    T[:3, 3] = eye
    return T


def orbit_poses(center: np.ndarray, radius: float, height: float,
                n: int = 36) -> List[np.ndarray]:
    """``n`` cam-to-world poses orbiting ``center`` (a turntable)."""
    out = []
    for k in range(n):
        a = 2.0 * np.pi * k / n
        eye = center + np.array([radius * np.cos(a), -abs(height),
                                 radius * np.sin(a)])
        out.append(look_at(eye, center))
    return out


def chase_cam_pose(cam_to_world: np.ndarray, back: float = 4.0,
                   up: float = 1.5) -> np.ndarray:
    """A follow camera behind and above a trajectory pose (the GUI's
    chase-cam mode)."""
    eye = cam_to_world[:3, 3] - cam_to_world[:3, 2] * back \
        - np.array([0.0, up, 0.0])
    target = cam_to_world[:3, 3] + cam_to_world[:3, 2] * 6.0
    return look_at(eye, target)


def render_orbit(
    engine: MapEngine,
    out_dir: str,
    center: Optional[np.ndarray] = None,
    radius: float = 8.0,
    height: float = 3.0,
    n_frames: int = 24,
    preview: PreviewType = PreviewType.COLOR,
) -> List[str]:
    """Write an orbit turntable of the map; returns the PNG paths. The
    default centre is the centroid of the allocated blocks (the scratch
    row excluded)."""
    os.makedirs(out_dir, exist_ok=True)
    if center is None:
        coords = engine.state.block_coords[engine.state.valid].cpu().numpy()
        coords = coords[(np.abs(coords) < (1 << 20)).all(axis=1)]
        center = ((coords.mean(axis=0) + 0.5) * engine.cfg.block_size
                  if len(coords) else np.zeros(3))
    paths = []
    for k, pose in enumerate(orbit_poses(np.asarray(center, float), radius,
                                         height, n_frames)):
        p = os.path.join(out_dir, f"orbit_{k:03d}.png")
        write_png(p, engine.get_image(preview, cam_to_world=pose))
        paths.append(p)
    return paths


def render_chase_sequence(
    dyn_slam,
    out_dir: str,
    every: int = 1,
    preview: PreviewType = PreviewType.COLOR,
) -> List[str]:
    """Chase-camera renders along the estimated trajectory, with the
    objects composited in where the pipeline has them."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, w2c in enumerate(dyn_slam.pose_history[1:]):
        if k % every:
            continue
        img = dyn_slam.get_static_map_raycast_preview(
            cam_to_world=chase_cam_pose(np.linalg.inv(w2c)), preview=preview)
        p = os.path.join(out_dir, f"chase_{k:04d}.png")
        write_png(p, img)
        paths.append(p)
    return paths
