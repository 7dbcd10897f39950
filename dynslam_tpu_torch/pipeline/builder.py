"""Build the static frame step from the top-level configuration — the
port of ``dynslam_tpu/pipeline/builder.py::build_fused``'s static branch
and ``pipeline/mapping.py::engine_config_from``, without the dataset IO
(the caller feeds frames to ``FusedPipeline.process_frame``)."""

from __future__ import annotations

from dynslam_tpu_torch.config import DynSlamConfig, StereoCalibration
from dynslam_tpu_torch.device import DeviceLike
from dynslam_tpu_torch.ops.tsdf import TsdfConfig
from dynslam_tpu_torch.pipeline.fused import FusedPipeline


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
