"""KITTI calibration and pose files — a numpy copy of
``dynslam_tpu/io/calib.py`` (``ReadKittiOdometryCalibration``,
DynSLAMGUI.cpp:1027-1089): the P0..P3 projection matrices and the
velodyne-to-camera transform (``Tr:`` in odometry files, ``Tr_velo_cam``
in tracking ones)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from dynslam_tpu_torch.config import Intrinsics, StereoCalibration


@dataclass(frozen=True)
class KittiCalibration:
    #: 3x4 projection matrices: P0 left-gray, P1 right-gray,
    #: P2 left-color, P3 right-color
    proj_left_gray: np.ndarray
    proj_right_gray: np.ndarray
    proj_left_color: np.ndarray
    proj_right_color: np.ndarray
    #: 4x4 velodyne -> left gray camera transform
    velo_to_left_cam: np.ndarray

    @property
    def left_color_intrinsics(self) -> Intrinsics:
        P = self.proj_left_color
        return Intrinsics(fx=float(P[0, 0]), fy=float(P[1, 1]),
                          cx=float(P[0, 2]), cy=float(P[1, 2]))

    @property
    def right_color_intrinsics(self) -> Intrinsics:
        P = self.proj_right_color
        return Intrinsics(fx=float(P[0, 0]), fy=float(P[1, 1]),
                          cx=float(P[0, 2]), cy=float(P[1, 2]))

    def stereo_calibration(self, baseline_m: Optional[float] = None
                           ) -> StereoCalibration:
        """Baseline from the colour pair's projection matrices unless
        given (the reference hardcodes 0.537150654273 m for KITTI,
        DynSLAMGUI.cpp:1185)."""
        f = float(self.proj_left_color[0, 0])
        if baseline_m is None:
            # P[0, 3] = -fx * baseline relative to cam0
            bx2 = -self.proj_left_color[0, 3] / f
            bx3 = -self.proj_right_color[0, 3] / float(
                self.proj_right_color[0, 0])
            baseline_m = float(bx3 - bx2)
        return StereoCalibration(baseline_m=baseline_m, focal_length_px=f)


def read_kitti_calibration(path: str) -> KittiCalibration:
    """Parse a KITTI odometry ``calib.txt`` or tracking ``calib/NNNN.txt``."""
    mats: dict = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            label = parts[0].rstrip(":")
            vals = [float(x) for x in parts[1:] if x != ":"]
            if len(vals) == 12:
                mats[label] = np.array(vals, dtype=np.float64).reshape(3, 4)
    for r in ("P0", "P1", "P2", "P3"):
        if r not in mats:
            raise ValueError(f"calibration file {path!r} missing {r}")
    tr_3x4 = mats.get("Tr", mats.get("Tr_velo_cam"))
    if tr_3x4 is None:
        raise ValueError(f"calibration file {path!r} missing Tr / Tr_velo_cam")
    velo_to_cam = np.eye(4, dtype=np.float64)
    velo_to_cam[:3, :] = tr_3x4
    return KittiCalibration(
        proj_left_gray=mats["P0"], proj_right_gray=mats["P1"],
        proj_left_color=mats["P2"], proj_right_color=mats["P3"],
        velo_to_left_cam=velo_to_cam,
    )


def write_kitti_calibration(path: str, calib: KittiCalibration) -> None:
    """Write ``calib`` in the odometry format."""
    def fmt(m):
        return " ".join(f"{v:.12e}" for v in np.asarray(m).reshape(-1))

    with open(path, "w") as f:
        f.write(f"P0: {fmt(calib.proj_left_gray)}\n")
        f.write(f"P1: {fmt(calib.proj_right_gray)}\n")
        f.write(f"P2: {fmt(calib.proj_left_color)}\n")
        f.write(f"P3: {fmt(calib.proj_right_color)}\n")
        f.write(f"Tr: {fmt(calib.velo_to_left_cam[:3, :])}\n")


def read_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry ground-truth poses (N, 4, 4), camera-to-world."""
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    n = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :] = rows.reshape(n, 3, 4)
    return poses


def write_kitti_poses(path: str, poses: np.ndarray) -> None:
    rows = np.asarray(poses)[:, :3, :].reshape(len(poses), 12)
    np.savetxt(path, rows, fmt="%.9e")
