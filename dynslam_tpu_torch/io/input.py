"""The frame reader — the port of ``dynslam_tpu/io/input.py``
(Input.{h,cpp}): ``InputConfig`` and the ``kitti_*`` presets (Input.h:
20-147) with the same names and values, ``Input`` (stereo PNGs and the
depth provider's depth, read with ``io/images.py`` instead of ``cv2``),
and ``FusedInput``, what the fused pipelines' evaluation reads of a
sequence. ``InGraphDepthProvider`` lives in ``io/depth_providers.py``
and is re-exported here."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from dynslam_tpu_torch.config import StereoCalibration
from dynslam_tpu_torch.io.depth_providers import (  # noqa: F401 (re-export)
    DepthProvider, InGraphDepthProvider, PrecomputedDepthProvider,
)
from dynslam_tpu_torch.io.images import read_png, resize_nearest


@dataclass
class InputConfig:
    """Folder layout of a dataset sequence. Ref: Input.h:20-57."""

    dataset_name: str = ""
    left_gray_folder: str = ""
    right_gray_folder: str = ""
    left_color_folder: str = ""
    right_color_folder: str = ""
    fname_format: str = "%06d.png"
    calibration_fname: str = "calib.txt"
    min_depth_m: float = -1.0
    max_depth_m: float = -1.0
    depth_folder: str = ""
    depth_fname_format: str = ""
    #: True = files hold metric depth (mm); False = disparity (px)
    read_depth: bool = False
    segmentation_folder: str = ""
    odometry_fname: str = ""
    velodyne_folder: str = ""
    velodyne_fname_format: str = ""
    tracklet_folder: str = ""


def kitti_odometry_config() -> InputConfig:
    """Ref: Input.h:61-86."""
    return InputConfig(
        dataset_name="kitti-odometry",
        left_gray_folder="image_0",
        right_gray_folder="image_1",
        left_color_folder="image_2",
        right_color_folder="image_3",
        fname_format="%06d.png",
        calibration_fname="calib.txt",
        min_depth_m=0.5,
        max_depth_m=20.0,
        depth_folder="precomputed-depth/Frames",
        depth_fname_format="%04d.xml",
        read_depth=True,
        segmentation_folder="seg_image_2/mnc",
        odometry_fname="ground-truth-poses.txt",
        velodyne_folder="velodyne",
        velodyne_fname_format="%06d.bin",
    )


def kitti_odometry_dispnet_config() -> InputConfig:
    """Ref: Input.h:141-147."""
    cfg = kitti_odometry_config()
    cfg.depth_folder = "precomputed-depth-dispnet"
    cfg.depth_fname_format = "%06d.pfm"
    cfg.read_depth = False
    return cfg


def kitti_odometry_lowres_config(factor: float) -> InputConfig:
    """Ref: Input.h:128-139."""
    cfg = kitti_odometry_config()
    cfg.left_gray_folder = f"image_0_{factor:.2f}"
    cfg.right_gray_folder = f"image_1_{factor:.2f}"
    cfg.left_color_folder = f"image_2_{factor:.2f}"
    cfg.right_color_folder = f"image_3_{factor:.2f}"
    cfg.depth_folder = f"precomputed-depth-elas-{factor:.2f}/Frames"
    cfg.segmentation_folder = f"seg_image_2-{factor:.2f}/mnc"
    return cfg


def kitti_tracking_config(sequence_id: int) -> InputConfig:
    """Ref: Input.h:92-118."""
    return InputConfig(
        dataset_name=f"kitti-tracking-sequence-{sequence_id:04d}",
        left_gray_folder=f"image_02/{sequence_id:04d}/",
        right_gray_folder=f"image_03/{sequence_id:04d}/",
        left_color_folder=f"image_02/{sequence_id:04d}/",
        right_color_folder=f"image_03/{sequence_id:04d}/",
        fname_format="%06d.png",
        calibration_fname=f"calib/{sequence_id:04d}.txt",
        min_depth_m=0.5,
        max_depth_m=20.0,
        depth_folder=f"precomputed-depth/{sequence_id:04d}/Frames",
        depth_fname_format="%04d.xml",
        read_depth=True,
        segmentation_folder=f"seg_image_02/{sequence_id:04d}/mnc",
        velodyne_folder=f"velodyne/{sequence_id:04d}/",
        velodyne_fname_format="%06d.bin",
        tracklet_folder=f"label_02/{sequence_id:04d}.txt",
    )


def kitti_tracking_dispnet_config(sequence_id: int) -> InputConfig:
    """Ref: Input.h:120-126."""
    cfg = kitti_tracking_config(sequence_id)
    cfg.depth_folder = f"precomputed-depth-dispnet/{sequence_id:04d}"
    cfg.depth_fname_format = "%06d.pfm"
    cfg.read_depth = False
    return cfg


class Input:
    """Reads stereo frames and their depth for a sequence
    (Input.{h,cpp}). ``read_next_frame`` loads the current frame's stereo
    pair and computes its depth, then advances; ``get_images`` returns
    the buffered frame. ``frame_idx`` points at the NEXT frame to read, as
    in the reference."""

    def __init__(
        self,
        dataset_folder: str,
        config: InputConfig,
        depth_provider: Optional[DepthProvider],
        frame_size: Tuple[int, int],  # (width, height)
        stereo_calibration: StereoCalibration,
        frame_offset: int = 0,
        input_scale: float = 1.0,
    ):
        self.dataset_folder = dataset_folder
        self.config = config
        self.depth_provider = depth_provider
        self.frame_width, self.frame_height = frame_size
        self.stereo_calibration = stereo_calibration
        self.frame_offset = frame_offset
        self.frame_idx = frame_offset
        self.input_scale = input_scale
        self._left_color: Optional[np.ndarray] = None
        self._right_color: Optional[np.ndarray] = None
        self._depth_mm: Optional[np.ndarray] = None

    def frame_path(self, folder: str, frame_idx: int) -> str:
        return os.path.join(self.dataset_folder, folder,
                            self.config.fname_format % frame_idx)

    def get_dataset_identifier(self) -> str:
        return self.config.dataset_name + "-" + os.path.basename(
            os.path.normpath(self.dataset_folder))

    def has_more_images(self) -> bool:
        return os.path.exists(
            self.frame_path(self.config.left_color_folder, self.frame_idx))

    def _read_image(self, folder: str, frame_idx: int) -> np.ndarray:
        """One colour frame as (H, W, 3) uint8 RGB, nearest-resized by
        1 / input_scale as the reference's ``cv::resize`` does."""
        path = self.frame_path(folder, frame_idx)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        rgb = read_png(path)
        if self.input_scale != 1.0:
            rgb = resize_nearest(rgb, None, 1.0 / self.input_scale,
                                 1.0 / self.input_scale)
        return rgb

    def read_left_color(self, frame_idx: int) -> np.ndarray:
        return self._read_image(self.config.left_color_folder, frame_idx)

    def read_right_color(self, frame_idx: int) -> np.ndarray:
        return self._read_image(self.config.right_color_folder, frame_idx)

    def load_frame(self, frame_idx: int):
        """Frame ``frame_idx``'s stereo pair and, where the depth comes
        from files, its depth: only reads, so a reader thread can run it
        (``io/prefetch.py``). Returns (left, right, depth or None)."""
        left = self.read_left_color(frame_idx)
        right = self.read_right_color(frame_idx)
        depth = None
        if isinstance(self.depth_provider, PrecomputedDepthProvider):
            depth = self.depth_provider.get_depth(
                frame_idx, self.stereo_calibration, self.input_scale)
        return left, right, depth

    def set_frame(self, left: np.ndarray, right: np.ndarray,
                  depth: Optional[np.ndarray] = None) -> None:
        """Make a loaded frame the current one and advance ``frame_idx``;
        a depth ``load_frame`` left out is computed from the pair here."""
        want = (self.frame_height, self.frame_width)
        if left.shape[:2] != want:
            raise ValueError(
                f"Unexpected left RGB frame size {left.shape[:2]}; "
                f"calibration specified {want} (format "
                f"{self.config.fname_format!r} in "
                f"{self.config.left_color_folder!r})")
        if right.shape[:2] != want:
            raise ValueError(f"Unexpected right RGB frame size "
                             f"{right.shape[:2]}; calibration specified "
                             f"{want}")
        if depth is None:
            depth = self.depth_provider.depth_from_stereo(
                left, right, self.stereo_calibration, self.input_scale)
        if depth.shape != want:
            raise ValueError(f"Unexpected depth map size {depth.shape}; "
                             f"expected {want}")
        self._left_color, self._right_color, self._depth_mm = \
            left, right, depth
        self.frame_idx += 1

    def read_next_frame(self) -> bool:
        self.set_frame(*self.load_frame(self.frame_idx))
        return True

    def get_images(self) -> Tuple[np.ndarray, np.ndarray]:
        """(left RGB uint8, depth int16 mm) of the last frame read."""
        if self._left_color is None:
            raise RuntimeError("call read_next_frame() first")
        return self._left_color, self._depth_mm

    def get_stereo_color(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._left_color, self._right_color

    def get_frame_images(self, frame_idx: int):
        """Random-access re-read of one frame's left RGB and depth, for
        delayed evaluation (Input::GetFrameCvImages, Input.cpp:11-34)."""
        rgb = self.read_left_color(frame_idx)
        if isinstance(self.depth_provider, PrecomputedDepthProvider):
            depth = self.depth_provider.get_depth(
                frame_idx, self.stereo_calibration, self.input_scale)
        else:
            right = self.read_right_color(frame_idx)
            depth = self.depth_provider.depth_from_stereo(
                rgb, right, self.stereo_calibration, self.input_scale)
        return rgb, depth

    @property
    def current_frame(self) -> int:
        """Index of the NEXT frame to be read (Input::GetCurrentFrame)."""
        return self.frame_idx


@dataclass
class FusedInput:
    """A sequence as the fused pipelines' evaluation sees it: its folder,
    layout, first frame and depth provider."""

    dataset_folder: str
    config: InputConfig = field(default_factory=kitti_odometry_config)
    frame_offset: int = 0
    depth_provider: InGraphDepthProvider = field(
        default_factory=InGraphDepthProvider)

    def get_dataset_identifier(self) -> str:
        """``<dataset name>-<folder name>`` (Input.cpp, ``input.py:158``)."""
        return self.config.dataset_name + "-" + os.path.basename(
            os.path.normpath(self.dataset_folder))
