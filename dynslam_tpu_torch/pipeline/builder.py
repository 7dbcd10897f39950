"""Pipeline factories — the port of ``dynslam_tpu/pipeline/builder.py``
(``BuildDynSlamKittiOdometry``, DynSLAMGUI.cpp:1109-1283):

- ``build_dynslam`` wires the staged pipeline (``Input``, a depth
  provider, segmentation, sparse scene flow, ``MapEngine``, the instance
  reconstructor, evaluation) from a KITTI-layout folder;
- ``build_fused`` builds the fused static or dynamic pipeline for the
  same folder, with its evaluation attached by ``attach_evaluation``;
- ``build_fused_static`` / ``build_fused_dynamic`` build the fused steps
  from a configuration alone (the caller feeds frames).

Every pipeline runs on ``device``: CUDA unless the caller passes
``"cpu"``. ``engine_config_from`` and ``instance_config_from`` live in
``pipeline/mapping.py`` and are re-exported here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from dynslam_tpu_torch.config import DynSlamConfig, StereoCalibration
from dynslam_tpu_torch.device import DeviceLike, resolve_device
from dynslam_tpu_torch.eval.fused_eval import FusedEvaluation
from dynslam_tpu_torch.io.calib import read_kitti_calibration, read_kitti_poses
from dynslam_tpu_torch.io.depth_providers import (
    InGraphDepthProvider, PrecomputedDepthProvider, StereoMatcherDepthProvider,
)
from dynslam_tpu_torch.io.images import png_size
from dynslam_tpu_torch.io.input import (
    FusedInput, Input, InputConfig, kitti_odometry_config,
    kitti_odometry_dispnet_config, kitti_odometry_lowres_config,
    kitti_tracking_config, kitti_tracking_dispnet_config,
)
from dynslam_tpu_torch.io.prefetch import PrefetchingInput
from dynslam_tpu_torch.io.segmentation import PrecomputedSegmentationProvider
from dynslam_tpu_torch.pipeline.dynslam import DynSlam
from dynslam_tpu_torch.pipeline.fused import FusedPipeline
from dynslam_tpu_torch.pipeline.fused_dynamic import FusedDynamicPipeline
from dynslam_tpu_torch.pipeline.mapping import (  # noqa: F401 (re-export)
    MapEngine, engine_config_from, instance_config_from,
)
from dynslam_tpu_torch.pipeline.sparse_sf import SparseSFProvider


def probe_frame_size(dataset_root: str, icfg: InputConfig,
                     scale: float = 1.0) -> Tuple[int, int]:
    """(width, height) from frame 1 or 0's PNG header (GetFrameSize,
    DynSLAMGUI.cpp:1094-1105)."""
    for probe in (1, 0):
        p = os.path.join(dataset_root, icfg.left_color_folder,
                         icfg.fname_format % probe)
        if os.path.exists(p):
            w, h = png_size(p)
            return int(w / scale), int(h / scale)
    raise FileNotFoundError(
        f"no frames found under {dataset_root}/{icfg.left_color_folder}")


def _resolve_dataset(dataset_root: str, config: DynSlamConfig,
                     kitti_tracking_sequence: Optional[int],
                     baseline_m: Optional[float]):
    """The dataset preset, calibration and frame size shared by the staged
    and fused factories: (config with the frame geometry and intrinsics
    filled in, input config, live scale, calibration)."""
    if kitti_tracking_sequence is not None:
        icfg = (kitti_tracking_dispnet_config(kitti_tracking_sequence)
                if config.use_dispnet
                else kitti_tracking_config(kitti_tracking_sequence))
    else:
        icfg = (kitti_odometry_dispnet_config() if config.use_dispnet
                else kitti_odometry_config())
    # prefer pre-scaled folders (depth and segmentation recomputed at the
    # low resolution, Input.h:128-139) over a live nearest resize
    live_scale = config.scale
    if kitti_tracking_sequence is None and config.scale != 1.0 \
            and not config.use_dispnet:
        lowres = kitti_odometry_lowres_config(1.0 / config.scale)
        if os.path.isdir(os.path.join(dataset_root,
                                      lowres.left_color_folder)):
            icfg = lowres
            live_scale = 1.0  # the folders are already downscaled
    calib = read_kitti_calibration(os.path.join(dataset_root,
                                                icfg.calibration_fname))
    width, height = probe_frame_size(dataset_root, icfg, live_scale)
    intr = calib.left_color_intrinsics
    if config.scale != 1.0:
        intr = intr.scaled(1.0 / config.scale)
    config = dataclasses.replace(
        config, frame_width=width, frame_height=height, intrinsics=intr,
        right_intrinsics=calib.right_color_intrinsics,
        calibration=calib.stereo_calibration(baseline_m))
    return config, icfg, live_scale, calib


def _prefetching(input_: Input, dataset_root: str, icfg: InputConfig,
                 config: DynSlamConfig) -> PrefetchingInput:
    """``input_`` read one frame ahead by a reader thread, which also warms
    the page cache for the segmentation dumps in dynamic mode."""
    return PrefetchingInput(
        input_, prefetch_seg_folder=(
            os.path.join(dataset_root, icfg.segmentation_folder)
            if config.dynamic_mode else None))


def _segmentation(dataset_root, icfg, config, frame_offset, live_scale,
                  min_detection_size_px):
    return PrecomputedSegmentationProvider(
        os.path.join(dataset_root, icfg.segmentation_folder), frame_offset,
        live_scale,
        min_detection_size_px=(min_detection_size_px
                               if min_detection_size_px is not None
                               else config.tracker.min_detection_size_px))


def build_dynslam(
    dataset_root: str,
    config: Optional[DynSlamConfig] = None,
    kitti_tracking_sequence: Optional[int] = None,
    use_live_stereo: bool = False,
    frame_offset: int = 0,
    with_instances: bool = True,
    with_evaluation: bool = False,
    csv_out_dir: Optional[str] = None,
    min_detection_size_px: Optional[int] = None,
    baseline_m: Optional[float] = None,
    use_ground_truth_poses: bool = False,
    use_prefetch: bool = False,
    device: DeviceLike = None,
    seed: int = 0,
) -> Tuple[DynSlam, Input]:
    """The staged pipeline for a KITTI-layout sequence, on ``device``;
    with ``use_prefetch`` the input is a ``PrefetchingInput``."""
    from dynslam_tpu_torch.eval.evaluation import Evaluation
    from dynslam_tpu_torch.instances.reconstructor import InstanceReconstructor

    dev = resolve_device(device)
    config, icfg, live_scale, calib = _resolve_dataset(
        dataset_root, config or DynSlamConfig(), kitti_tracking_sequence,
        baseline_m)
    intr = config.intrinsics
    stereo_calib = config.calibration
    if use_live_stereo:
        depth_provider = StereoMatcherDepthProvider(
            config.stereo, config.min_depth_m, config.max_depth_m, device=dev)
    else:
        depth_provider = PrecomputedDepthProvider(
            os.path.join(dataset_root, icfg.depth_folder),
            icfg.depth_fname_format, input_is_depth=icfg.read_depth,
            min_depth_m=config.min_depth_m, max_depth_m=config.max_depth_m)
    input_ = Input(dataset_root, icfg, depth_provider,
                   (config.frame_width, config.frame_height), stereo_calib,
                   frame_offset, live_scale)
    if use_prefetch:
        input_ = _prefetching(input_, dataset_root, icfg, config)
    engine = MapEngine(engine_config_from(config), config.decay, intr,
                       device=dev)
    sf_provider = SparseSFProvider((intr.fx, intr.cx, intr.cy), stereo_calib,
                                   config.vo, seed=seed, device=dev)
    seg_provider = instance_reconstructor = None
    if config.dynamic_mode:
        seg_provider = _segmentation(dataset_root, icfg, config, frame_offset,
                                     live_scale, min_detection_size_px)
        if with_instances:
            instance_reconstructor = InstanceReconstructor(config, device=dev)
    evaluation = None
    if with_evaluation:
        evaluation = Evaluation(
            dataset_root, icfg, input_, calib, config,
            csv_out_dir=csv_out_dir or os.path.join(dataset_root, "csv"),
            device=dev)
    gt_poses = None
    if use_ground_truth_poses:
        gt_poses = read_kitti_poses(os.path.join(dataset_root,
                                                 icfg.odometry_fname))
        if frame_offset:
            gt_poses = gt_poses[frame_offset:]
    dyn = DynSlam(config, engine, segmentation_provider=seg_provider,
                  sparse_sf_provider=sf_provider,
                  instance_reconstructor=instance_reconstructor,
                  evaluation=evaluation, ground_truth_poses=gt_poses)
    return dyn, input_


def build_fused(
    dataset_root: str,
    config: Optional[DynSlamConfig] = None,
    kitti_tracking_sequence: Optional[int] = None,
    frame_offset: int = 0,
    min_detection_size_px: Optional[int] = None,
    baseline_m: Optional[float] = None,
    use_prefetch: bool = False,
    with_evaluation: bool = False,
    csv_out_dir: Optional[str] = None,
    device: DeviceLike = None,
    seed: int = 0,
):
    """The fused pipeline for a KITTI-layout sequence: ``FusedPipeline``
    (static) or ``FusedDynamicPipeline`` (dynamic mode), with a
    ``FusedEvaluation`` attached as ``pipe.evaluation`` when asked. The
    fused steps compute stereo depth themselves, so the ``Input`` carries
    an ``InGraphDepthProvider``; segmentation comes from the MNC dumps;
    with ``use_prefetch`` the input is a ``PrefetchingInput``. Returns
    (pipeline, input, segmentation provider or None)."""
    config, icfg, live_scale, calib = _resolve_dataset(
        dataset_root, config or DynSlamConfig(), kitti_tracking_sequence,
        baseline_m)
    input_ = Input(dataset_root, icfg,
                   InGraphDepthProvider(config.min_depth_m,
                                        config.max_depth_m),
                   (config.frame_width, config.frame_height),
                   config.calibration, frame_offset, live_scale)
    if use_prefetch:
        input_ = _prefetching(input_, dataset_root, icfg, config)
    seg_provider = None
    if config.dynamic_mode:
        seg_provider = _segmentation(dataset_root, icfg, config, frame_offset,
                                     live_scale, min_detection_size_px)
        pipe = build_fused_dynamic(config, config.calibration, device=device,
                                   seed=seed)
    else:
        pipe = build_fused_static(config, config.calibration, device=device,
                                  seed=seed)
    if with_evaluation:
        pipe.evaluation = FusedEvaluation(
            dataset_root, icfg, input_, calib, config,
            csv_out_dir=csv_out_dir or os.path.join(dataset_root, "csv"),
            device=pipe.device)
    return pipe, input_, seg_provider


def build_fused_static(config: DynSlamConfig, calib: StereoCalibration,
                       device: DeviceLike = None, seed: int = 0,
                       ) -> FusedPipeline:
    """The static fused pipeline on ``device`` (CUDA unless the caller
    passes ``"cpu"``)."""
    return FusedPipeline(engine_config_from(config), config.stereo,
                         config.vo, config.decay, calib, device=device,
                         seed=seed)


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
