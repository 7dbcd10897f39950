"""Frozen copy of ``dynslam_tpu_torch/config.py`` for the benchmark's plain
reference, which imports nothing of the port. Its docstring follows.

Configuration of the port's slices — the fields of
``dynslam_tpu/config.py`` that the port reads, with the same names and
defaults (``tests/test_torch_config.py`` holds them equal).

The port keeps its own copy so that it runs without importing anything
of the JAX package. Its functions read configurations by attribute, so
the JAX package's objects of the same names are accepted as they are.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

#: voxels per block edge (ITM SDF_BLOCK_SIZE); 8**3 = 512 voxels a block
VOXEL_BLOCK_SIZE = 8


@dataclass(frozen=True)
class StereoCalibration:
    """Stereo rig geometry (the KITTI baseline and focal length)."""

    baseline_m: float = 0.537150654273
    focal_length_px: float = 707.0912

    @property
    def bf(self) -> float:
        """baseline * focal: converts disparity (px) <-> depth (m)."""
        return self.baseline_m * self.focal_length_px


@dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics (fx, fy, cx, cy) in pixels."""

    fx: float = 707.0912
    fy: float = 707.0912
    cx: float = 601.8873
    cy: float = 183.1104

    def as_tuple(self) -> Tuple[float, float, float, float]:
        return (self.fx, self.fy, self.cx, self.cy)

    def scaled(self, s: float) -> "Intrinsics":
        return Intrinsics(self.fx * s, self.fy * s, self.cx * s, self.cy * s)


@dataclass(frozen=True)
class SceneParams:
    """TSDF scene parameters."""

    voxel_size_m: float = 0.05
    #: truncation band in meters (ITM ``mu``)
    mu_m: float = 0.30
    #: max accumulated fusion weight per voxel (ITM ``maxW``)
    max_weight: int = 100
    view_frustum_min_m: float = 0.5
    view_frustum_max_m: float = 20.0

    @property
    def block_size_m(self) -> float:
        return self.voxel_size_m * VOXEL_BLOCK_SIZE


@dataclass(frozen=True)
class VoxelDecayParams:
    """Voxel garbage collection ("decay")."""

    enabled: bool = True
    min_decay_age: int = 200
    max_decay_weight: int = 1


@dataclass(frozen=True)
class MapParams:
    """Map capacities: block pool, local index grid, per-frame caps."""

    pool_capacity: int = 2 ** 17
    local_dims: Tuple[int, int, int] = (160, 48, 160)
    max_new_blocks_per_frame: int = 8192
    max_visible_blocks: int = 16384
    use_depth_weighting: bool = False
    raycast_coarse_steps: int = 16
    raycast_fine_steps: int = 14


@dataclass(frozen=True)
class InstanceMapParams:
    """Per-object volumes (InstanceReconstructor.cpp:365-401): one pooled
    volume per reconstructed object, ``max_objects`` of them."""

    voxel_size_m: float = 0.035
    mu_m: float = 1.0
    max_weight: int = 100
    #: pooled object volumes (the pool's slot axis S)
    max_objects: int = 8
    #: mask slots a frame (K: cut/remove and object RANSAC), at most 32
    max_detections: int = 16
    blocks_per_object: int = 2048
    local_dims: Tuple[int, int, int] = (64, 24, 80)
    max_new_blocks_per_frame: int = 1024
    raycast_coarse_steps: int = 20
    raycast_fine_steps: int = 16
    #: (rows, cols) of the bbox-centred fusion crop, clamped to the frame
    fusion_crop: Tuple[int, int] = (256, 512)
    #: masks whose bbox exceeds the crop: True fuses the full masked frame
    #: instead, False fuses the truncated crop and counts the lost pixels
    oversize_mask_fallback: bool = True


@dataclass(frozen=True)
class VisualOdometryParams:
    """Sparse scene flow / egomotion (the libviso2 equivalents)."""

    nms_radius: int = 3
    bucket_max_features: int = 15
    bucket_width: int = 50
    bucket_height: int = 50
    max_matches: int = 2048
    #: LK refinement runs on at most this many (compacted) valid matches
    refine_cap: int = 1024
    max_candidates: int = 2048
    ransac_iters: int = 500
    inlier_threshold_px: float = 2.0
    gn_iters: int = 8
    irls_rounds: int = 8
    tukey_c_px: float = 0.5
    descriptor_radius: int = 5
    max_disparity: int = 192
    epipolar_band_px: float = 1.5
    flow_radius_px: float = 100.0


@dataclass(frozen=True)
class StereoMatcherParams:
    """Census cost-volume stereo matcher."""

    max_disparity: int = 128
    census_radius: int = 3
    aggregation_radius: int = 2
    lr_max_diff: float = 1.5
    uniqueness: float = 0.95
    subpixel: bool = True
    #: horizontal invalid runs up to this many px are filled; 0 disables
    fill_gaps: int = 0


@dataclass(frozen=True)
class TrackerParams:
    """Instance tracker and track state machine (InstanceTracker.h:21-26,
    Track.h:88-98, Track.cpp:167-209)."""

    score_threshold: float = 0.10
    inactive_frame_threshold: int = 50
    #: fewest masked scene-flow vectors an object motion needs
    min_flow_vectors: int = 18
    #: RANSAC hypotheses, IRLS rounds and final GN steps of the per-object
    #: motion estimate
    object_ransac_iters: int = 200
    object_irls_rounds: int = 2
    object_gn_iters: int = 4
    trans_error_threshold_low: float = 0.030
    trans_error_threshold_high: float = 0.550
    max_uncertain_frames_static: int = 5
    max_uncertain_frames_dynamic: int = 1
    min_detection_size_px: int = 45
    copy_mask_scale: float = 1.0
    delete_mask_scale: float = 1.2
    conservative_mask_scale: float = 0.97


@dataclass(frozen=True)
class EvaluationParams:
    """LIDAR depth-evaluation protocol (Evaluation.cpp:105-127)."""

    enabled: bool = True
    semantic_evaluation: bool = True
    evaluation_delay: int = 0
    #: delta_max sweep: 0.5 then 1..12 px, plus KITTI-style (3px AND 5%)
    delta_maxes: Tuple[float, ...] = (0.5, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12)
    kitti_style: bool = True
    min_depth_m: float = 0.5
    max_depth_m: float = 20.0


@dataclass(frozen=True)
class DynSlamConfig:
    """The top-level configuration (the gflags surface,
    DynSLAMGUI.cpp:26-72)."""

    frame_width: int = 1242
    frame_height: int = 375
    calibration: StereoCalibration = field(default_factory=StereoCalibration)
    intrinsics: Intrinsics = field(default_factory=Intrinsics)
    right_intrinsics: Intrinsics = field(default_factory=Intrinsics)
    scene: SceneParams = field(default_factory=SceneParams)
    decay: VoxelDecayParams = field(default_factory=VoxelDecayParams)
    map: MapParams = field(default_factory=MapParams)
    instance_map: InstanceMapParams = field(default_factory=InstanceMapParams)
    vo: VisualOdometryParams = field(default_factory=VisualOdometryParams)
    stereo: StereoMatcherParams = field(default_factory=StereoMatcherParams)
    tracker: TrackerParams = field(default_factory=TrackerParams)
    evaluation: EvaluationParams = field(default_factory=EvaluationParams)
    #: reconstruct moving objects in volumes of their own
    dynamic_mode: bool = True
    #: reconstruct every recognised car, moving or parked
    always_reconstruct_objects: bool = True
    #: fuse/segment only every k-th frame (DynSlam.h:308-318); the fused
    #: steps fuse every frame, the evaluation's CSV names record it
    fusion_every: int = 1
    #: the staged path's odometry: scene-flow VO (True) or ICP against the
    #: map render, with VO as its fallback (False) (DynSlam.cpp:89-100)
    external_odometry: bool = True
    #: 5-pass bilateral filter of the input depth before fusion
    use_bilateral_filter: bool = False
    #: depth provider clamps: 0 = invalid
    min_depth_m: float = 0.5
    max_depth_m: float = 20.0
    #: read DispNet disparity dumps instead of ELAS depth dumps
    use_dispnet: bool = False
    #: image downscale factor (the ``--scale`` flag)
    scale: float = 1.0
    #: per-object direct (photometric) motion refinement, a staged-path
    #: option; the evaluation's CSV names record it
    use_direct_refinement: bool = False

    def replace(self, **kw) -> "DynSlamConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config(width: int = 128, height: int = 96) -> DynSlamConfig:
    """Small configuration for CPU tests: tiny frames and pools, scaled
    intrinsics."""
    intr = Intrinsics(fx=100.0, fy=100.0, cx=width / 2.0, cy=height / 2.0)
    return DynSlamConfig(
        frame_width=width,
        frame_height=height,
        calibration=StereoCalibration(baseline_m=0.5, focal_length_px=100.0),
        intrinsics=intr,
        right_intrinsics=intr,
        scene=SceneParams(voxel_size_m=0.05, mu_m=0.3, view_frustum_max_m=20.0),
        map=MapParams(
            pool_capacity=4096,
            local_dims=(48, 32, 48),
            max_new_blocks_per_frame=2048,
        ),
        instance_map=InstanceMapParams(
            max_objects=4,
            blocks_per_object=256,
            local_dims=(16, 12, 20),
            max_new_blocks_per_frame=256,
        ),
        vo=VisualOdometryParams(
            max_matches=512,
            max_candidates=1024,
            ransac_iters=100,
            max_disparity=48,
        ),
        stereo=StereoMatcherParams(max_disparity=32),
    )
