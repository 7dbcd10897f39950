"""Dataset folder layouts — ``InputConfig`` and the ``kitti_*`` presets of
``dynslam_tpu/io/input.py`` (Input.h:20-147), with the same names and
values — and ``FusedInput``, what the fused pipelines' evaluation reads of
the reference's ``Input`` (the frame reader itself, which decodes PNGs,
is not ported)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


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


class InGraphDepthProvider:
    """The fused steps compute stereo depth themselves; this stands for
    their depth provider in the CSV names (``depth_providers.py:164-178``
    of the JAX package)."""

    def get_name(self) -> str:
        return "ingraph"


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
