"""Build the static and dynamic frame steps from the top-level
configuration — the port of ``dynslam_tpu/pipeline/builder.py::
build_fused``, ``pipeline/mapping.py::engine_config_from`` and the
configuration part of ``FusedDynamicPipeline.__init__``, without the
frame reader (the caller feeds frames to ``process_frame``); and
``attach_evaluation``, the ``with_evaluation`` part of ``build_fused``."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from dynslam_tpu_torch.config import DynSlamConfig, StereoCalibration
from dynslam_tpu_torch.device import DeviceLike
from dynslam_tpu_torch.eval.fused_eval import FusedEvaluation
from dynslam_tpu_torch.io.calib import read_kitti_calibration
from dynslam_tpu_torch.io.input import FusedInput
from dynslam_tpu_torch.ops.tsdf import TsdfConfig
from dynslam_tpu_torch.pipeline.fused import FusedPipeline
from dynslam_tpu_torch.pipeline.fused_dynamic import FusedDynamicPipeline


def engine_config_from(config: DynSlamConfig) -> TsdfConfig:
    """The static map's ``TsdfConfig`` from a ``DynSlamConfig``."""
    return TsdfConfig(
        pool_capacity=config.map.pool_capacity,
        local_dims=config.map.local_dims,
        max_new_blocks=config.map.max_new_blocks_per_frame,
        max_visible_blocks=min(config.map.pool_capacity,
                               config.map.max_visible_blocks),
        voxel_size=config.scene.voxel_size_m,
        mu=config.scene.mu_m,
        max_weight=float(config.scene.max_weight),
        min_depth=config.min_depth_m,
        max_depth=config.max_depth_m,
        use_depth_weighting=config.map.use_depth_weighting,
        raycast_coarse_steps=config.map.raycast_coarse_steps,
        raycast_fine_steps=config.map.raycast_fine_steps,
        width=config.frame_width,
        height=config.frame_height,
        fx=config.intrinsics.fx,
        fy=config.intrinsics.fy,
        cx=config.intrinsics.cx,
        cy=config.intrinsics.cy,
    )


def build_fused_static(config: DynSlamConfig, calib: StereoCalibration,
                       device: DeviceLike = None, seed: int = 0,
                       ) -> FusedPipeline:
    """The static fused pipeline on ``device`` (CUDA unless the caller
    passes ``"cpu"``)."""
    return FusedPipeline(engine_config_from(config), config.stereo,
                         config.vo, config.decay, calib, device=device,
                         seed=seed)


def instance_config_from(config: DynSlamConfig) -> TsdfConfig:
    """An object volume's ``TsdfConfig`` at the full frame (the render
    configuration; ``build_fused_dynamic`` derives the crop-sized fusion
    one from it)."""
    imp = config.instance_map
    return TsdfConfig(
        pool_capacity=imp.blocks_per_object,
        local_dims=imp.local_dims,
        max_new_blocks=imp.max_new_blocks_per_frame,
        max_visible_blocks=min(imp.blocks_per_object,
                               imp.max_new_blocks_per_frame * 2),
        voxel_size=imp.voxel_size_m,
        mu=imp.mu_m,
        max_weight=float(imp.max_weight),
        min_depth=config.min_depth_m,
        max_depth=config.max_depth_m,
        use_depth_weighting=config.map.use_depth_weighting,
        raycast_coarse_steps=imp.raycast_coarse_steps,
        raycast_fine_steps=imp.raycast_fine_steps,
        width=config.frame_width,
        height=config.frame_height,
        fx=config.intrinsics.fx,
        fy=config.intrinsics.fy,
        cx=config.intrinsics.cx,
        cy=config.intrinsics.cy,
    )


def attach_evaluation(pipe, config: DynSlamConfig, dataset_root: str,
                      csv_out_dir: Optional[str] = None) -> FusedEvaluation:
    """Attach a ``FusedEvaluation`` of the sequence at ``dataset_root``
    (its calibration file and LIDAR scans, in the KITTI odometry layout,
    from its first frame) to a fused pipeline as ``pipe.evaluation``, on
    the pipeline's device; the CSVs go to ``csv_out_dir`` (default
    ``<dataset_root>/csv``). The dynamic pipeline drives it itself; the
    static pipeline's caller submits each frame's ``(raycast.depth,
    depth_m, None, used_blocks, decayed_blocks)`` and closes it at the
    end."""
    inp = FusedInput(dataset_root)
    calib = read_kitti_calibration(
        os.path.join(dataset_root, inp.config.calibration_fname))
    pipe.evaluation = FusedEvaluation(
        dataset_root, inp.config, inp, calib, config,
        csv_out_dir=csv_out_dir or os.path.join(dataset_root, "csv"),
        device=pipe.device)
    return pipe.evaluation


def build_fused_dynamic(config: DynSlamConfig, calib: StereoCalibration,
                        device: DeviceLike = None, seed: int = 0,
                        dispatch_lag: int = 2) -> FusedDynamicPipeline:
    """The dynamic fused pipeline on ``device`` (CUDA unless the caller
    passes ``"cpu"``): the static map's configuration, an object volume's
    at the full frame and at the fusion crop (its frustum test runs in
    crop pixels), the per-object RANSAC parameters, K mask slots (at
    least the S volumes: the reference removes every possibly-dynamic
    detection from the view, reconstructed or not) and S volumes."""
    imp = config.instance_map
    icfg = instance_config_from(config)
    icfg_fuse = dataclasses.replace(
        icfg, width=min(imp.fusion_crop[1], config.frame_width),
        height=min(imp.fusion_crop[0], config.frame_height))
    obj_params = dataclasses.replace(
        config.vo,
        ransac_iters=config.tracker.object_ransac_iters,
        irls_rounds=config.tracker.object_irls_rounds,
        gn_iters=config.tracker.object_gn_iters,
    )
    K = min(max(imp.max_detections, imp.max_objects), 32)
    return FusedDynamicPipeline(
        config, calib, engine_config_from(config), icfg, icfg_fuse,
        obj_params, K, imp.max_objects, device=device, seed=seed,
        dispatch_lag=dispatch_lag)
