"""MapEngine — the port of ``dynslam_tpu/pipeline/mapping.py``, the
reference's InfiniTamDriver: one TSDF volume and its camera pose with the
driver's API (``UpdateView``, ``SetPose``, ``Integrate``,
``PrepareNextStep``, ``Decay``, ``DecayCatchup``, ``Reap``, ``GetImage``,
``GetFloatImage``, memory queries — InfiniTamDriver.h:111-284).

The map lives on the device and is updated in place; the pose is host
numpy (the staged pipeline chains poses on the host). ``integrate`` runs
K1 at one volume (``ops/integrate.py``); a full-frame render is K2
(``ops/raycast.py``), from the current pose (with the window and visible
list ``integrate`` left, as the JAX package caches them) or from any
other pose, whose window is built at that pose; a render at another size
is the dense tracer ``tsdf.raycast``, as the JAX package routes it.

``engine_config_from`` and ``instance_config_from`` build the static map's
and an object volume's ``TsdfConfig`` from a ``DynSlamConfig``.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from dynslam_tpu_torch.config import DynSlamConfig, Intrinsics, VoxelDecayParams
from dynslam_tpu_torch.device import DeviceLike, resolve_device, upload
from dynslam_tpu_torch.ops import depth as depth_ops
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.ops.icp import IcpResult, icp_track
from dynslam_tpu_torch.ops.integrate import integrate
from dynslam_tpu_torch.ops.raycast import Raycast, raycast


class PreviewType(enum.Enum):
    """Raycast preview modes (PreviewType.h:6-8)."""

    DEPTH = "depth"
    GRAY = "gray"
    COLOR = "color"
    NORMAL = "normal"
    WEIGHT = "weight"
    LATEST_RAYCAST = "latest_raycast"


def _normals_from_points(points: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """Image-space normals from the raycast point map (InfiniTAM's
    ImageNormals mode): cross product of neighbour differences."""
    du = np.zeros_like(points)
    dv = np.zeros_like(points)
    du[:, 1:-1] = points[:, 2:] - points[:, :-2]
    dv[1:-1, :] = points[2:, :] - points[:-2, :]
    n = np.cross(dv, du)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 1e-9, n / np.maximum(norm, 1e-9), 0.0)
    return np.where(hit[..., None], n, 0.0)


def rigid_inverse_np(w2c: np.ndarray) -> np.ndarray:
    """(R^T, -R^T t) of a 4x4 pose in float32 — ``MapEngine``'s
    ``cam_to_world`` (``mapping.py:121-127`` of the JAX package)."""
    w2c = np.asarray(w2c, np.float32)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = w2c[:3, :3].T
    out[:3, 3] = -w2c[:3, :3].T @ w2c[:3, 3]
    return out


def lu_inverse_np(m: np.ndarray) -> np.ndarray:
    """(..., 4, 4) float32 inverses by LU on the host, as
    ``jnp.linalg.inv`` computes them on the CPU (numpy's ``inv`` parts
    from it by an ulp, which moves a block across an allocation boundary
    now and then)."""
    return torch.linalg.inv(torch.from_numpy(
        np.ascontiguousarray(m, dtype=np.float32))).numpy()


class MapEngine:
    """One TSDF volume and its camera pose, on ``device`` (CUDA unless the
    caller passes ``"cpu"``)."""

    def __init__(self, cfg: tsdf.TsdfConfig, decay_params: VoxelDecayParams,
                 intrinsics: Optional[Intrinsics] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.decay_params = decay_params
        self.device = resolve_device(device)
        self.state = tsdf.create_state(cfg, self.device)
        intr = intrinsics or Intrinsics(cfg.fx, cfg.fy, cfg.cx, cfg.cy)
        self.intrinsics_vec = upload(np.asarray(
            [intr.fx, intr.fy, intr.cx, intr.cy], np.float32), self.device)
        #: world-to-camera pose, host float32 (SetPose receives
        #: new_pose.inverse(), DynSlam.cpp:93)
        self.pose_w2c = np.eye(4, dtype=np.float32)
        self.frame_idx = 0
        self.fused_frames = 0
        self._view_rgb: Optional[torch.Tensor] = None
        self._view_depth_m: Optional[torch.Tensor] = None
        self._last_raycast: Optional[Raycast] = None
        self._last_raycast_pose: Optional[np.ndarray] = None
        #: (origin, grid, slots, mask) left by integrate() for the
        #: same-pose render of prepare_next_step
        self._frame_cache = None
        #: cumulative pool-full allocation drops, on the device
        self._dropped_total = torch.zeros((), dtype=torch.int32,
                                          device=self.device)

    # -- view & pose ------------------------------------------------------
    def _on_device(self, x, dtype) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=dtype)
        return upload(np.asarray(x), self.device).to(dtype)

    def update_view(self, rgb, depth_mm, bilateral: bool = False) -> None:
        """The view: RGB (H, W, 3) uint8 and depth (H, W) int16 mm, numpy
        or tensors; mm -> m, and the 5-pass bilateral filter when asked
        (viewBuilder->UpdateView, InfiniTamDriver.cpp:211-224)."""
        self._view_rgb = self._on_device(rgb, torch.uint8)
        d = depth_ops.depth_m_from_mm(self._on_device(depth_mm, torch.int16))
        if bilateral:
            d = depth_ops.bilateral_filter_depth(d)
        self._view_depth_m = d

    def set_view_device(self, rgb: torch.Tensor, depth_m: torch.Tensor) -> None:
        """A view already on the device (the silhouette-cut views)."""
        self._view_rgb = rgb
        self._view_depth_m = depth_m

    def set_pose(self, world_to_cam) -> None:
        self.pose_w2c = np.asarray(world_to_cam, np.float32).copy()

    def get_pose(self) -> np.ndarray:
        return self.pose_w2c.copy()

    @property
    def cam_to_world(self) -> np.ndarray:
        return rigid_inverse_np(self.pose_w2c)

    def _poses(self, c2w: np.ndarray, w2c: np.ndarray):
        """(c2w, w2c) as device tensors, in one upload."""
        both = upload(np.stack([c2w, w2c]).astype(np.float32), self.device)
        return both[0], both[1]

    # -- mapping ----------------------------------------------------------
    def integrate(self) -> None:
        """Allocation and fusion (K1) of the current view at the current
        pose (denseMapper->ProcessFrame, InfiniTamDriver.h:140-145)."""
        if self._view_depth_m is None:
            raise RuntimeError("MapEngine.integrate: update_view first")
        c2w_np = self.cam_to_world
        c2w, w2c = self._poses(c2w_np, self.pose_w2c)
        origin = tsdf.compute_origin(self.cfg, c2w)
        grid = tsdf.build_local_grid(self.cfg, self.state, origin)
        self.state, grid, (_, n_drop) = tsdf.allocate(
            self.cfg, self.state, grid, origin, self._view_depth_m, c2w,
            self.frame_idx)
        self._dropped_total = self._dropped_total + n_drop
        slots, mask = tsdf.visible_blocks(self.cfg, self.state, grid, origin,
                                          w2c)
        integrate(self.cfg, self.state, slots, mask, self._view_rgb,
                  self._view_depth_m, w2c, self.frame_idx)
        self._frame_cache = (c2w_np, c2w, origin, grid, slots, mask)
        self.frame_idx += 1
        self.fused_frames += 1

    def prepare_next_step(self) -> None:
        """Render from the current pose and keep it for tracking and
        previews (trackingController->Prepare, InfiniTamDriver.h:148-158)."""
        self._last_raycast = self._raycast_from(self.cam_to_world,
                                                reuse_cache=True)
        self._last_raycast_pose = self.cam_to_world

    def _raycast_from(self, cam_to_world: np.ndarray,
                      width: Optional[int] = None,
                      height: Optional[int] = None,
                      reuse_cache: bool = False) -> Raycast:
        """A render from ``cam_to_world`` (host 4x4). At the full frame K2:
        with ``reuse_cache`` over the window and visible list ``integrate``
        built at this pose, else over a window built at the given pose. At
        another size the dense tracer, over a window built at the pose,
        with the engine's intrinsics (``mapping.py:175-203`` of the JAX
        package)."""
        c2w_np = np.asarray(cam_to_world, np.float32)
        if (width or self.cfg.width, height or self.cfg.height) != (
                self.cfg.width, self.cfg.height):
            c2w = upload(c2w_np, self.device)
            origin = tsdf.compute_origin(self.cfg, c2w)
            grid = tsdf.build_local_grid(self.cfg, self.state, origin)
            return tsdf.raycast(self.cfg, self.state, grid, origin, c2w,
                                self.intrinsics_vec, width, height)
        cache = self._frame_cache
        if reuse_cache and cache is not None \
                and np.array_equal(cache[0], c2w_np):
            _, c2w, origin, grid, slots, mask = cache
        else:
            # the JAX package lists the visible blocks at jnp.linalg.inv of
            # the pose here, not its rigid inverse
            c2w, w2c = self._poses(c2w_np, lu_inverse_np(c2w_np))
            origin = tsdf.compute_origin(self.cfg, c2w)
            grid = tsdf.build_local_grid(self.cfg, self.state, origin)
            slots, mask = tsdf.visible_blocks(self.cfg, self.state, grid,
                                              origin, w2c)
        return raycast(self.cfg, self.state, grid, origin, slots, mask, c2w,
                       self.intrinsics_vec)

    # -- depth tracking -----------------------------------------------------
    def track_icp(self, depth_m, init_world_to_cam=None,
                  stride: int = 4) -> IcpResult:
        """Point-to-plane ICP of a depth map (m) against the latest render
        (trackingController->Track, InfiniTamDriver.h:120-124); on failure
        the result carries the initial pose with success False."""
        if self._last_raycast is None:
            raise RuntimeError("MapEngine.track_icp: prepare_next_step first")
        init = self.pose_w2c if init_world_to_cam is None \
            else np.asarray(init_world_to_cam, np.float32)
        ref = np.linalg.inv(self._last_raycast_pose).astype(np.float32)
        poses = upload(np.stack([ref, init]).astype(np.float32), self.device)
        return icp_track(self._on_device(depth_m, torch.float32),
                         self._last_raycast.points, self._last_raycast.hit,
                         poses[0], poses[1], self.intrinsics_vec,
                         stride=stride)

    # -- decay / GC -------------------------------------------------------
    def decay(self, blocking: bool = False):
        """The regular decay (InfiniTamDriver.h:198-206): the freed-block
        count stays on the device unless ``blocking``."""
        if not self.decay_params.enabled:
            return 0
        # no block can reach min_decay_age before that many frames
        if self.frame_idx < int(self.decay_params.min_decay_age):
            return 0
        self.state, n = tsdf.decay(
            self.cfg, self.state, self.frame_idx,
            float(self.decay_params.max_decay_weight),
            int(self.decay_params.min_decay_age))
        return int(n) if blocking else n

    def decay_catchup(self) -> int:
        """All pending decay, whatever the blocks' age (DecayCatchup,
        InfiniTamDriver.h:208-216)."""
        if not self.decay_params.enabled:
            return 0
        self.state, n = tsdf.decay(
            self.cfg, self.state, self.frame_idx,
            float(self.decay_params.max_decay_weight),
            int(self.decay_params.min_decay_age), force_all=True)
        return int(n)

    def reap(self, max_weight: float) -> int:
        """Full decay at a custom weight threshold, for abandoned object
        volumes (Track::ReapReconstruction, InfiniTamDriver.h:218-235)."""
        self.state, n = tsdf.decay(self.cfg, self.state, self.frame_idx,
                                   float(max_weight), 0, force_all=True)
        return int(n)

    def reset(self) -> None:
        """denseMapper->ResetScene (InfiniTamDriver.h:283)."""
        self.state = tsdf.create_state(self.cfg, self.device)
        self.fused_frames = 0

    # -- previews ---------------------------------------------------------
    def get_raycast(self, cam_to_world: Optional[np.ndarray] = None,
                    width: Optional[int] = None,
                    height: Optional[int] = None) -> Raycast:
        if cam_to_world is None:
            if self._last_raycast is None:
                self.prepare_next_step()
            return self._last_raycast
        # the evaluation passes the current pose explicitly: serve the
        # prepare_next_step render
        if (self._last_raycast is not None and width is None
                and height is None and self._last_raycast_pose is not None
                and np.allclose(np.asarray(cam_to_world),
                                self._last_raycast_pose, atol=1e-6)):
            return self._last_raycast
        return self._raycast_from(cam_to_world, width, height)

    def get_image(self, preview: PreviewType = PreviewType.COLOR,
                  cam_to_world: Optional[np.ndarray] = None) -> np.ndarray:
        """Raycast previews as (H, W, 3) uint8 (ITMMainEngine::GetImage,
        InfiniTamDriver.cpp:165-186)."""
        rc = self.get_raycast(cam_to_world)
        if preview == PreviewType.COLOR:
            return rc.color.cpu().numpy()
        if preview == PreviewType.DEPTH:
            scaled = np.clip(rc.depth.cpu().numpy() / self.cfg.max_depth, 0, 1)
            return np.stack([(scaled * 255).astype(np.uint8)] * 3, -1)
        if preview == PreviewType.WEIGHT:
            scaled = np.clip(rc.weight.cpu().numpy() / self.cfg.max_weight,
                             0, 1)
            return np.stack([(scaled * 255).astype(np.uint8)] * 3, -1)
        if preview in (PreviewType.NORMAL, PreviewType.GRAY,
                       PreviewType.LATEST_RAYCAST):
            hit = rc.hit.cpu().numpy()
            n = _normals_from_points(rc.points.cpu().numpy(), hit)
            if preview == PreviewType.NORMAL:
                return ((n * 0.5 + 0.5) * 255).astype(np.uint8)
            # gray: headlight shading |n . view|
            img = (np.where(hit, np.abs(n[..., 2]), 0.0) * 255).astype(
                np.uint8)
            return np.stack([img] * 3, -1)
        raise ValueError(preview)

    def get_float_image(self, cam_to_world: Optional[np.ndarray] = None
                        ) -> torch.Tensor:
        """Raycast depth in metres, on the device (GetFloatImage, used by
        the evaluation, InfiniTamDriver.cpp:188-209)."""
        return self.get_raycast(cam_to_world).depth

    # -- memory telemetry (InfiniTamDriver.h:241-250) ---------------------
    def get_used_block_count(self) -> int:
        return int(tsdf.memory_stats(self.cfg, self.state)[0])

    def get_used_memory_bytes(self) -> int:
        return int(tsdf.memory_stats(self.cfg, self.state)[1])

    def get_dropped_allocation_count(self) -> int:
        """Blocks not allocated because the pool was full, cumulative."""
        return int(self._dropped_total)

    def get_saved_decay_memory_bytes(self) -> int:
        return int(tsdf.memory_stats(self.cfg, self.state)[3])

    def is_decay_enabled(self) -> bool:
        return self.decay_params.enabled


def engine_config_from(config: DynSlamConfig) -> tsdf.TsdfConfig:
    """The static map's ``TsdfConfig`` from a ``DynSlamConfig``."""
    return tsdf.TsdfConfig(
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


def instance_config_from(config: DynSlamConfig) -> tsdf.TsdfConfig:
    """An object volume's ``TsdfConfig`` at the full frame
    (``InstanceReconstructor.__init__`` of the JAX package)."""
    imp = config.instance_map
    return tsdf.TsdfConfig(
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
