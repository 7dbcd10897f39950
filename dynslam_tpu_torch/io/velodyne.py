"""KITTI Velodyne scans: ``.bin`` files of N x 4 float32 rows (x, y, z,
reflectance) — a numpy copy of ``dynslam_tpu/io/velodyne.py``
(Evaluation/VelodyneIO.{h,cpp})."""

from __future__ import annotations

import os

import numpy as np

from dynslam_tpu_torch import native
from dynslam_tpu_torch.native import fastio


class VelodyneIO:
    def __init__(self, folder: str, fname_format: str = "%06d.bin"):
        self.folder = folder
        self.fname_format = fname_format

    def frame_path(self, frame_idx: int) -> str:
        return os.path.join(self.folder, self.fname_format % frame_idx)

    def frame_available(self, frame_idx: int) -> bool:
        return os.path.exists(self.frame_path(frame_idx))

    def read_frame(self, frame_idx: int) -> np.ndarray:
        """(N, 4) float32 [x, y, z, reflectance] in the velodyne frame:
        the native parser, or ``read_numpy`` under
        ``DYNSLAM_NO_NATIVE_BUILD``."""
        if native.mode() == "native":
            return fastio.read_velodyne(self.frame_path(frame_idx))
        return read_numpy(self.frame_path(frame_idx))


def read_numpy(path: str) -> np.ndarray:
    """The numpy twin of ``fastio.read_velodyne``."""
    data = np.fromfile(path, dtype=np.float32)
    if data.size % 4 != 0:
        raise ValueError(f"corrupt velodyne frame {path!r}: {data.size} "
                         "floats is not a multiple of 4")
    return data.reshape(-1, 4)


def write_frame(path: str, points: np.ndarray) -> None:
    """Write (N, 4) float32 points."""
    pts = np.asarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"velodyne points must be (N, 4), not {pts.shape}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pts.tofile(path)
