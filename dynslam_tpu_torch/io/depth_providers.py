"""Depth providers — the port of ``dynslam_tpu/io/depth_providers.py``, the
reference's stereo -> depth contract (DepthProvider.h:45-76): a
disparity (or, for ELAS dumps, depth) map in, int16 depth in mm out, 0 =
invalid.

- ``PrecomputedDepthProvider`` reads per-frame ``.pfm`` float disparity
  (DispNet), OpenCV XML depth-mm dumps (ELAS, ``io/images.py``) or
  ``.npy`` arrays (PrecomputedDepthProvider.cpp:22-75);
- ``StereoMatcherDepthProvider`` runs the census matcher
  ``ops/stereo.py::compute_disparity`` on ``device``;
- ``InGraphDepthProvider`` stands for the fused steps, which compute
  stereo depth themselves.
"""

from __future__ import annotations

import abc
import os

import numpy as np
import torch

from dynslam_tpu_torch.config import StereoCalibration, StereoMatcherParams
from dynslam_tpu_torch.device import DeviceLike, resolve_device
from dynslam_tpu_torch.io.images import read_opencv_xml
from dynslam_tpu_torch.ops import depth as depth_ops
from dynslam_tpu_torch.utils.pfm import read_pfm


class DepthProvider(abc.ABC):
    """stereo pair -> disparity -> int16 depth (mm), 0 = invalid."""

    def __init__(self, input_is_depth: bool, min_depth_m: float,
                 max_depth_m: float):
        self.input_is_depth = input_is_depth
        self.min_depth_m = min_depth_m
        self.max_depth_m = max_depth_m

    @abc.abstractmethod
    def disparity_map_from_stereo(self, left_rgb: np.ndarray,
                                  right_rgb: np.ndarray) -> np.ndarray:
        """Float disparity (px) or, if ``input_is_depth``, int16 mm."""

    @abc.abstractmethod
    def get_name(self) -> str: ...

    def depth_from_stereo(self, left_rgb: np.ndarray, right_rgb: np.ndarray,
                          calib: StereoCalibration,
                          scale: float = 1.0) -> np.ndarray:
        """The whole stereo -> int16 depth-mm path
        (DepthProvider::DepthFromStereo)."""
        raw = self.disparity_map_from_stereo(left_rgb, right_rgb)
        return self.depth_from_disparity_map(raw, calib, scale)

    def depth_from_disparity_map(self, disparity: np.ndarray,
                                 calib: StereoCalibration,
                                 scale: float = 1.0) -> np.ndarray:
        if self.input_is_depth:
            # already metric depth in mm (ELAS XML dumps)
            return np.asarray(disparity, dtype=np.int16)
        max_mm = int(self.max_depth_m * 1000)
        if max_mm >= 32767:
            raise RuntimeError(
                f"Unsupported maximum depth of {self.max_depth_m} m "
                f"({max_mm} mm, larger than the int16 limit).")
        disp = disparity if torch.is_tensor(disparity) else torch.from_numpy(
            np.ascontiguousarray(disparity, dtype=np.float32))
        out = depth_ops.depth_mm_from_disparity(
            disp, calib.bf, min_depth_m=self.min_depth_m,
            max_depth_m=self.max_depth_m, scale=scale)
        return out.cpu().numpy()


class PrecomputedDepthProvider(DepthProvider):
    """Reads per-frame disparity or depth from disk
    (PrecomputedDepthProvider.cpp:22-75)."""

    def __init__(self, folder: str, fname_format: str, input_is_depth: bool,
                 min_depth_m: float = 0.5, max_depth_m: float = 20.0):
        super().__init__(input_is_depth, min_depth_m, max_depth_m)
        self.folder = folder
        self.fname_format = fname_format
        self._frame_idx = 0

    def set_frame(self, frame_idx: int) -> None:
        self._frame_idx = frame_idx

    def frame_path(self, frame_idx: int) -> str:
        return os.path.join(self.folder, self.fname_format % frame_idx)

    def read_precomputed(self, frame_idx: int) -> np.ndarray:
        path = self.frame_path(frame_idx)
        if path.endswith(".pfm"):
            # DispNet float disparity; non-finite values mark invalid
            disp = read_pfm(path)
            return np.where(np.isfinite(disp), disp, 0.0).astype(np.float32)
        if path.endswith(".xml"):
            # an OpenCV XML storage of one depth-mm matrix (ELAS)
            return read_opencv_xml(path).astype(np.int16)
        if path.endswith(".npy"):
            return np.load(path)
        raise ValueError(f"unsupported precomputed depth format: {path!r}")

    def disparity_map_from_stereo(self, left_rgb, right_rgb) -> np.ndarray:
        return self.read_precomputed(self._frame_idx)

    def get_depth(self, frame_idx: int, calib: StereoCalibration,
                  scale: float = 1.0) -> np.ndarray:
        """Depth of one frame by index (the evaluation's random access,
        PrecomputedDepthProvider.h:44-66)."""
        return self.depth_from_disparity_map(
            self.read_precomputed(frame_idx), calib, scale)

    def get_name(self) -> str:
        return ("precomputed-dispnet" if not self.input_is_depth
                else "precomputed-elas")


class StereoMatcherDepthProvider(DepthProvider):
    """Disparity from the census cost-volume matcher (``ops/stereo.py``)
    on ``device`` (CUDA unless the caller passes ``"cpu"``)."""

    def __init__(self, params: StereoMatcherParams | None = None,
                 min_depth_m: float = 0.5, max_depth_m: float = 20.0,
                 device: DeviceLike = None):
        super().__init__(False, min_depth_m, max_depth_m)
        self.params = params or StereoMatcherParams()
        self.device = resolve_device(device)

    def disparity_map_from_stereo(self, left_rgb, right_rgb) -> torch.Tensor:
        from dynslam_tpu_torch.ops import stereo

        def gray(rgb):
            # the JAX matcher's own unrounded float gray
            # (stereo.py::_to_gray_f32)
            f = torch.as_tensor(np.asarray(rgb)).to(self.device).float()
            if f.dim() == 2:
                return f
            return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]

        return stereo.compute_disparity(gray(left_rgb), gray(right_rgb),
                                        self.params)

    def get_name(self) -> str:
        return "tpu-census-bm"


class InGraphDepthProvider(DepthProvider):
    """The fused steps compute stereo depth themselves; this stands for
    their depth provider in the frame reader and in the CSV names
    (``depth_providers.py:164-178`` of the JAX package): all zeros."""

    def __init__(self, min_depth_m: float = 0.5, max_depth_m: float = 20.0):
        super().__init__(True, min_depth_m, max_depth_m)

    def disparity_map_from_stereo(self, left_rgb, right_rgb):
        return np.zeros(np.asarray(left_rgb).shape[:2], np.int16)

    def get_name(self) -> str:
        return "ingraph"
