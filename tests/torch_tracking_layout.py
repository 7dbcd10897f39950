"""A KITTI-odometry folder re-laid as a KITTI-tracking sequence, the layout
of ``io/input.py::kitti_tracking_config`` (Input.h:92-118), for the tests
and ``chip_smoke.py``. It imports no JAX: the card's machine has none.

``relayout_as_tracking(odometry_root, tracking_root, sequence_id)`` puts
each file of the odometry folder where the tracking preset reads it, as a
hard link where the file system allows one, else as a copy:

- ``image_2/``, ``image_3/`` -> ``image_02/NNNN/``, ``image_03/NNNN/``
  (the preset's gray folders are the colour ones: the tracking layout
  takes its gray frames from the colour PNGs);
- ``precomputed-depth/Frames/`` -> ``precomputed-depth/NNNN/Frames/``,
  ``precomputed-depth-dispnet/`` -> ``precomputed-depth-dispnet/NNNN/``;
- ``seg_image_2/mnc/`` -> ``seg_image_02/NNNN/mnc/``;
- ``velodyne/`` -> ``velodyne/NNNN/``;
- ``tracklets.txt`` -> ``label_02/NNNN.txt``;
- ``calib.txt`` -> ``calib/NNNN.txt``, written as a KITTI tracking
  calibration file writes it: ``P0:`` to ``P3:``, then ``R_rect``,
  ``Tr_velo_cam`` and ``Tr_imu_velo`` without a colon.

The rig is rectified, so ``R_rect`` is the identity; both packages read
``Tr_velo_cam`` and ignore ``R_rect``, as the reference does. The
odometry folder's ``ground-truth-poses.txt`` has no place in the tracking
layout and is left out.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

#: (odometry folder, tracking folder with ``{seq}`` for the sequence id)
FOLDERS = (
    ("image_2", "image_02/{seq}"),
    ("image_3", "image_03/{seq}"),
    ("precomputed-depth/Frames", "precomputed-depth/{seq}/Frames"),
    ("precomputed-depth-dispnet", "precomputed-depth-dispnet/{seq}"),
    ("seg_image_2/mnc", "seg_image_02/{seq}/mnc"),
    ("velodyne", "velodyne/{seq}"),
)
#: an IMU-to-velodyne transform for the file's last line; neither package
#: reads it
TR_IMU_VELO = np.array([
    [9.999976e-01, 7.553071e-04, -2.035826e-03, -8.086759e-01],
    [-7.854027e-04, 9.998898e-01, -1.482298e-02, 3.195559e-01],
    [2.024406e-03, 1.482454e-02, 9.998881e-01, -7.997231e-01]])


def _fmt(m) -> str:
    return " ".join(f"{v:.12e}" for v in np.asarray(m, np.float64).ravel())


def write_tracking_calibration(path: str, calib) -> None:
    """``calib`` (``io/calib.py::KittiCalibration``) as a KITTI tracking
    ``calib/NNNN.txt``."""
    with open(path, "w") as f:
        for label, m in (("P0:", calib.proj_left_gray),
                         ("P1:", calib.proj_right_gray),
                         ("P2:", calib.proj_left_color),
                         ("P3:", calib.proj_right_color),
                         ("R_rect", np.eye(3)),
                         ("Tr_velo_cam", calib.velo_to_left_cam[:3, :]),
                         ("Tr_imu_velo", TR_IMU_VELO)):
            f.write(f"{label} {_fmt(m)}\n")


def _place(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def relayout_as_tracking(odometry_root: str, tracking_root: str,
                         sequence_id: int = 0) -> str:
    """Lay ``odometry_root``'s files out as tracking sequence
    ``sequence_id`` under ``tracking_root`` (emptied first); returns
    ``tracking_root``."""
    from dynslam_tpu_torch.io.calib import read_kitti_calibration

    seq = f"{sequence_id:04d}"
    shutil.rmtree(tracking_root, ignore_errors=True)
    for src_rel, dst_rel in FOLDERS:
        src = os.path.join(odometry_root, src_rel)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(tracking_root, dst_rel.format(seq=seq))
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            _place(os.path.join(src, name), os.path.join(dst, name))
    for sub in ("calib", "label_02"):
        os.makedirs(os.path.join(tracking_root, sub), exist_ok=True)
    write_tracking_calibration(
        os.path.join(tracking_root, "calib", f"{seq}.txt"),
        read_kitti_calibration(os.path.join(odometry_root, "calib.txt")))
    labels = os.path.join(odometry_root, "tracklets.txt")
    if os.path.exists(labels):
        _place(labels, os.path.join(tracking_root, "label_02", f"{seq}.txt"))
    return tracking_root
