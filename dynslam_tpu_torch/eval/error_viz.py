"""LIDAR-vs-depth error overlay — the port of
``dynslam_tpu/eval/error_viz.py``, the headless form of the reference
GUI's visual diff modes (ErrorVisualizationCallback /
SegmentedVisualizationCallback, DynSLAMGUI.cpp:94-100,256-300).

Each LIDAR point that projects into the image is splatted onto the dimmed
camera image, coloured by its disparity error against the evaluated depth
map: green within ``delta_max``, red beyond it, blue where the depth map
has no value. Host numpy in the JAX package's dtypes (the projections in
the calibration's float64), so the overlay is byte-identical.
"""

from __future__ import annotations

import numpy as np

#: splat colours (RGB): within delta_max, beyond it, no depth
GOOD, ERROR, MISSING = (40, 220, 40), (230, 40, 40), (60, 90, 230)


def render_depth_error(
    lidar: np.ndarray,  # (N, >= 3) velodyne points
    depth_m: np.ndarray,  # (H, W) evaluated depth (rendered or input)
    rgb: np.ndarray,  # (H, W, 3) uint8 backdrop
    velo_to_cam: np.ndarray,
    proj_left: np.ndarray,
    proj_right: np.ndarray,
    bf: float,
    delta_max: float = 3.0,
    min_depth: float = 0.5,
    max_depth: float = 20.0,
    splat: int = 1,
) -> np.ndarray:
    """Returns an (H, W, 3) uint8 overlay (dimmed rgb + error splats)."""
    h, w = depth_m.shape
    pts = np.concatenate(
        [lidar[:, :3], np.ones((len(lidar), 1), lidar.dtype)], axis=1)
    cam = pts @ velo_to_cam.T
    z = cam[:, 2]
    pl = cam @ proj_left.T
    pr = cam @ proj_right.T
    ul = pl[:, 0] / pl[:, 2]
    vl = pl[:, 1] / pl[:, 2]
    ur = pr[:, 0] / pr[:, 2]
    col = np.round(ul).astype(np.int32)
    row = np.round(vl).astype(np.int32)
    lidar_disp = ul - ur
    ok = ((z >= min_depth) & (z <= max_depth)
          & (col >= 0) & (col < w) & (row >= 0) & (row < h)
          & (lidar_disp >= 0))
    col, row, lidar_disp = col[ok], row[ok], lidar_disp[ok]

    d = depth_m[row, col]
    missing = np.abs(d) < 1e-5
    with np.errstate(divide="ignore"):
        disp = np.where(missing, np.inf, bf / np.maximum(d, 1e-5))
    err = ~missing & (np.abs(disp - lidar_disp) > delta_max)
    good = ~missing & ~err

    out = (rgb.astype(np.float32) * 0.45).astype(np.uint8)
    colors = np.zeros((len(col), 3), np.uint8)
    colors[good] = GOOD
    colors[err] = ERROR
    colors[missing] = MISSING
    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            out[np.clip(row + dy, 0, h - 1), np.clip(col + dx, 0, w - 1)] = \
                colors
    return out
