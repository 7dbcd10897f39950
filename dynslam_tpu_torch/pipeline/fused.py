"""The static-scene frame step — the port of
``dynslam_tpu/pipeline/fused.py``.

Per frame: census stereo -> depth -> feature detect / circular match /
LK refine -> RANSAC egomotion (ICP fallback) -> pose chain -> TSDF
allocate + fuse (CUDA kernel) -> full-frame raycast (CUDA kernel) ->
voxel decay. PyTorch runs it eagerly; the map is updated in place (this
replaces the JAX package's ``donate_argnames``: a carry must not be used
after it was passed to ``fused_step``).

Two decisions are taken on the host, one device sync each per frame:
the ICP fallback runs only when sparse VO failed, and the local grid is
rebuilt only when the window origin moved (origin hysteresis).
``FusedOutputs.host_syncs`` counts them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dynslam_tpu_torch.config import (
    StereoCalibration, StereoMatcherParams, VisualOdometryParams,
    VoxelDecayParams,
)
from dynslam_tpu_torch.device import DeviceLike, resolve_device
from dynslam_tpu_torch.ops import egomotion as ego_ops
from dynslam_tpu_torch.ops import features as feat_ops
from dynslam_tpu_torch.ops import stereo as stereo_ops
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.ops.icp import icp_track
from dynslam_tpu_torch.ops.integrate import integrate
from dynslam_tpu_torch.ops.raycast import Raycast, raycast
from dynslam_tpu_torch.utils.se3 import inverse

#: ``sampler(frame_idx, valid) -> (ransac_iters, 3)`` RANSAC draws; lets a
#: test feed the JAX package's draws in place of the generator's
Sampler = Callable[[int, torch.Tensor], torch.Tensor]


class FusedCarry(NamedTuple):
    """Cross-frame state (the JAX package's field names)."""

    state: tsdf.TsdfState
    pose_w2c: torch.Tensor  # (4, 4) world-to-camera
    held_motion: torch.Tensor  # (4, 4) last successful VO delta
    prev_l: feat_ops.Features
    prev_r: feat_ops.Features
    prev_lg: torch.Tensor  # (H, W) f32 previous left gray
    prev_rg: torch.Tensor  # (H, W) f32 previous right gray
    frame_idx: int
    dropped: torch.Tensor  # () int32 cumulative pool-full drops
    origin: torch.Tensor  # (3,) int32 local-window origin of ``grid``
    grid: torch.Tensor  # (n_cells,) int32 local index cache
    #: previous frame's model render, the ICP fallback's reference
    prev_rc_points: torch.Tensor  # (H, W, 3) f32
    prev_rc_hit: torch.Tensor  # (H, W) bool


class FusedOutputs(NamedTuple):
    raycast: Raycast
    depth_m: torch.Tensor  # (H, W) f32 stereo depth of this frame
    pose_w2c: torch.Tensor  # (4, 4)
    vo_success: torch.Tensor  # () bool
    vo_inliers: torch.Tensor  # () int64
    n_new_blocks: torch.Tensor  # () int32
    n_freed_blocks: torch.Tensor  # () int32
    #: voxels in blocks gated into fusion, ray samples the raycast marched
    fused_voxels: torch.Tensor
    march_samples: torch.Tensor
    used_blocks: torch.Tensor  # () post-decay allocated blocks
    decayed_blocks: torch.Tensor  # () cumulative decayed blocks
    #: whether this frame ran the decay pass (the static decay gate)
    decay_ran: bool
    #: device -> host syncs this frame's host branches took
    host_syncs: int


def _refine_matches(lg, rg, prev_lg, prev_rg, flow, valid, params):
    """LK refinement of at most ``refine_cap`` valid matches (the first
    ones in index order); matches past the cap are dropped."""
    N = flow.shape[0]
    cap = min(params.refine_cap, N)
    if cap < N:
        ridx = tsdf.compact_mask(valid, cap, N)
        r_ok = ridx < N
        refined = feat_ops.refine_flow_quad(
            lg, rg, prev_lg, prev_rg, flow[torch.clamp(ridx, max=N - 1)])
        flow = torch.cat([flow, flow[:1]])
        flow[torch.where(r_ok, ridx, N)] = refined
        flow = flow[:N]
        valid = valid & (torch.cumsum(valid.to(torch.int32), 0) <= cap)
    else:
        flow = torch.where(valid[:, None], feat_ops.refine_flow_quad(
            lg, rg, prev_lg, prev_rg, flow), flow)
    return flow, valid


def motion_with_icp_fallback(est, carry: FusedCarry, depth_m, intr_vec):
    """The frame's camera delta: sparse VO when it succeeded, else ICP
    against the previous model render, else the held motion. Returns
    (delta, host_syncs)."""
    if bool(est.success):
        return est.matrix, 1
    res = icp_track(depth_m, carry.prev_rc_points, carry.prev_rc_hit,
                    carry.pose_w2c, carry.held_motion @ carry.pose_w2c,
                    intr_vec)
    delta = res.world_to_cam @ inverse(carry.pose_w2c)
    return torch.where(res.success, delta, carry.held_motion), 1


def _stage(name: str):
    """A named range for torch.profiler (``chip_smoke.py`` tabulates
    them); next to nothing when no profiler runs."""
    return torch.profiler.record_function(f"fused_step.{name}")


class FrontEnd(NamedTuple):
    """Stereo depth, sparse scene flow and the camera motion of a frame."""

    depth_m: torch.Tensor  # (H, W) f32
    cur_l: feat_ops.Features
    cur_r: feat_ops.Features
    flow: torch.Tensor  # (N, 8) RawFlow rows
    valid: torch.Tensor  # (N,) bool
    est: ego_ops.MotionEstimate  # sparse VO's estimate
    held: torch.Tensor  # (4, 4) the frame's camera delta
    pose_w2c: torch.Tensor  # (4, 4)
    host_syncs: int


def front_end(cfg, stereo_params, vo_params, carry, left_gray, right_gray,
              calib_vec, intr_vec, bf, generator=None,
              sampler: Optional[Sampler] = None) -> FrontEnd:
    """Stereo -> depth, features -> circular match -> LK refine, RANSAC
    egomotion with the ICP fallback; ``carry`` is read, not changed."""
    with _stage("stereo"):
        depth_m = stereo_ops.depth_m_from_stereo(
            left_gray, right_gray, stereo_params, bf, cfg.min_depth,
            cfg.max_depth)

    with _stage("features"):
        cur_l, cur_r = feat_ops.detect_features_pair(left_gray, right_gray,
                                                     vo_params)
        flow, valid = feat_ops.circular_match(cur_l, cur_r, carry.prev_l,
                                              carry.prev_r, vo_params)
        flow, valid = _refine_matches(left_gray, right_gray, carry.prev_lg,
                                      carry.prev_rg, flow, valid, vo_params)
    with _stage("egomotion"):
        est = ego_ops.estimate_motion(
            flow, valid, calib_vec, torch.zeros(6, device=flow.device),
            vo_params, generator=generator,
            sample_ids=None if sampler is None else sampler(carry.frame_idx,
                                                            valid))
        held, syncs = motion_with_icp_fallback(est, carry, depth_m, intr_vec)
        pose_w2c = held @ carry.pose_w2c  # new = delta @ old
    return FrontEnd(depth_m, cur_l, cur_r, flow, valid, est, held, pose_w2c,
                    syncs)


class StaticMap(NamedTuple):
    """The static map after one frame's allocate, fuse, raycast and decay."""

    state: tsdf.TsdfState
    grid: torch.Tensor
    origin: torch.Tensor
    n_new: torch.Tensor
    n_drop: torch.Tensor
    mask: torch.Tensor  # (V,) visible blocks fused this frame
    raycast: Raycast
    n_freed: torch.Tensor
    host_syncs: int


def static_map(cfg, decay_enabled, carry, depth_m, rgb, pose_w2c, intr_vec,
               max_decay_weight, min_decay_age) -> StaticMap:
    """Allocate, fuse (K1), raycast (K2) and decay the static map of
    ``carry`` from one view, in place."""
    c2w = inverse(pose_w2c)
    with _stage("allocate"):
        # origin hysteresis: keep the grid while the camera stays within 4
        # blocks of its anchor (allocate keeps it fresh); decay frees
        # slots, so a frame that decays always rebuilds
        origin_new = tsdf.compute_origin(cfg, c2w)
        keep = carry.frame_idx > 1 and not decay_enabled \
            and bool(((origin_new - carry.origin).abs() <= 4).all())
        syncs = int(carry.frame_idx > 1 and not decay_enabled)
        state = carry.state
        if keep:
            origin, grid = carry.origin, carry.grid
        else:
            origin = origin_new
            grid = tsdf.build_local_grid(cfg, state, origin)
        state, grid, (n_new, n_drop) = tsdf.allocate(
            cfg, state, grid, origin, depth_m, c2w, carry.frame_idx)
        slots, mask = tsdf.visible_blocks(cfg, state, grid, origin, pose_w2c)
    with _stage("integrate"):
        integrate(cfg, state, slots, mask, rgb, depth_m, pose_w2c,
                  carry.frame_idx)
    with _stage("raycast"):
        rc = raycast(cfg, state, grid, origin, slots, mask, c2w, intr_vec)

    with _stage("decay"):
        if decay_enabled:
            state, n_freed = tsdf.decay(cfg, state, carry.frame_idx + 1,
                                        max_decay_weight, min_decay_age)
        else:
            n_freed = torch.zeros((), dtype=torch.int32,
                                  device=depth_m.device)
    return StaticMap(state, grid, origin, n_new, n_drop, mask, rc, n_freed,
                     syncs)


def fused_step(
    cfg: tsdf.TsdfConfig,
    stereo_params: StereoMatcherParams,
    vo_params: VisualOdometryParams,
    decay_enabled: bool,
    carry: FusedCarry,
    left_gray: torch.Tensor,  # (H, W) f32
    right_gray: torch.Tensor,  # (H, W) f32
    rgb: torch.Tensor,  # (H, W, 3) uint8
    calib_vec: torch.Tensor,  # (4,) fx, cu, cv, baseline (VO)
    intr_vec: torch.Tensor,  # (4,) fx, fy, cx, cy (raycast)
    bf: float,
    max_decay_weight: float,
    min_decay_age: int,
    generator: Optional[torch.Generator] = None,
    sampler: Optional[Sampler] = None,
):
    """One full frame; returns (carry', FusedOutputs). ``carry.state`` is
    updated in place. RANSAC draws come from ``sampler`` when given, else
    from ``generator``."""
    fe = front_end(cfg, stereo_params, vo_params, carry, left_gray,
                   right_gray, calib_vec, intr_vec, bf, generator, sampler)
    sm = static_map(cfg, decay_enabled, carry, fe.depth_m, rgb, fe.pose_w2c,
                    intr_vec, max_decay_weight, min_decay_age)
    state, rc = sm.state, sm.raycast
    carry2 = FusedCarry(
        state=state, pose_w2c=fe.pose_w2c, held_motion=fe.held,
        prev_l=fe.cur_l, prev_r=fe.cur_r, prev_lg=left_gray,
        prev_rg=right_gray, frame_idx=carry.frame_idx + 1,
        dropped=carry.dropped + sm.n_drop, origin=sm.origin, grid=sm.grid,
        prev_rc_points=rc.points, prev_rc_hit=rc.hit,
    )
    outs = FusedOutputs(
        raycast=rc, depth_m=fe.depth_m, pose_w2c=fe.pose_w2c,
        vo_success=fe.est.success, vo_inliers=fe.est.num_inliers,
        n_new_blocks=sm.n_new, n_freed_blocks=sm.n_freed,
        fused_voxels=sm.mask.sum(dtype=torch.int32) * tsdf.BLOCK3,
        march_samples=rc.march_samples,
        used_blocks=tsdf.memory_stats(cfg, state)[0],
        # a copy: decay adds to the state's counter in place
        decayed_blocks=state.decayed_blocks.clone(), decay_ran=decay_enabled,
        host_syncs=fe.host_syncs + sm.host_syncs,
    )
    return carry2, outs


def _to_device(x, dtype, device, copy: bool) -> torch.Tensor:
    """A numpy array or tensor as a ``dtype`` tensor on ``device``. From
    host memory this is a blocking copy (one host sync); a tensor
    already on the device is copied on the device, or not at all."""
    if not torch.is_tensor(x):
        # a read-only array (a JAX array's view, say) is copied first:
        # torch does not take non-writable memory
        x = torch.from_numpy(np.require(x, requirements="W"))
    return x.to(device=device, dtype=dtype, copy=copy)


def upload_frame(left_gray, right_gray, rgb, device):
    """A frame's inputs on ``device``, in the ``fused_step.upload`` range:
    float32 copies of the gray images (they become carry.prev_lg /
    prev_rg, so a view would see the caller's later writes into its
    buffers) and the RGB image, or the left gray one in three channels
    where there is none. Returns (left, right, rgb)."""
    with _stage("upload"):
        lg = _to_device(left_gray, torch.float32, device, copy=True)
        rg = _to_device(right_gray, torch.float32, device, copy=True)
        if rgb is None:
            rgb = torch.clamp(lg, 0, 255).to(torch.uint8)[..., None].expand(
                *lg.shape, 3).contiguous()
        else:
            rgb = _to_device(rgb, torch.uint8, device, copy=False)
    return lg, rg, rgb


class FusedPipeline:
    """Host wrapper: frame 0 seeds features and the view (no fusion, as
    there is no VO delta yet); every later frame runs ``fused_step``."""

    def __init__(
        self,
        cfg: tsdf.TsdfConfig,
        stereo_params: StereoMatcherParams,
        vo_params: VisualOdometryParams,
        decay_params: VoxelDecayParams,
        calib: StereoCalibration,
        device: DeviceLike = None,
        seed: int = 0,
        sampler: Optional[Sampler] = None,
    ):
        self.cfg = cfg
        self.stereo_params = stereo_params
        self.vo_params = vo_params
        self.decay_params = decay_params
        # origin hysteresis lets the camera drift 4 blocks from the anchor
        # before the grid re-centres; the window must cover the frustum at
        # max_depth with that slack to spare, or leading-edge geometry is
        # never allocated
        ext = np.asarray(cfg.local_dims, np.float64) * cfg.block_size
        slack = 4.0 * cfg.block_size
        horiz = min(ext[0], ext[2])
        fwd = 0.85 * horiz - slack
        lat = 0.5 * horiz - slack
        vert = 0.5 * ext[1] - slack
        need_lat = cfg.max_depth * max(cfg.cx, cfg.width - cfg.cx) / cfg.fx
        need_vert = cfg.max_depth * max(cfg.cy, cfg.height - cfg.cy) / cfg.fy
        if not (fwd >= cfg.max_depth and lat >= need_lat
                and vert >= need_vert):
            raise ValueError(
                f"local_dims {cfg.local_dims} too small for max_depth "
                f"{cfg.max_depth} m + 4-block hysteresis slack: forward "
                f"{fwd:.1f} m (need {cfg.max_depth:.1f}), lateral "
                f"{lat:.1f} m (need {need_lat:.1f}), vertical {vert:.1f} m "
                f"(need {need_vert:.1f})")
        self.device = resolve_device(device)
        dev = self.device
        self.calib_vec = torch.tensor(
            [cfg.fx, cfg.cx, cfg.cy, calib.baseline_m], device=dev)
        self.intr_vec = torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy],
                                     device=dev)
        self.bf = calib.bf
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.sampler = sampler
        self.carry: Optional[FusedCarry] = None
        self.last_outputs: Optional[FusedOutputs] = None
        self._frames = 0
        #: ``eval.fused_eval.FusedEvaluation`` (``builder.attach_evaluation``)
        #: or None; the caller submits each frame's outputs to it
        self.evaluation = None

    def _fresh_carry(self, lg, rg) -> FusedCarry:
        prev_l, prev_r = feat_ops.detect_features_pair(lg, rg, self.vo_params)
        dev = self.device
        return FusedCarry(
            state=tsdf.create_state(self.cfg, dev),
            pose_w2c=torch.eye(4, device=dev),
            held_motion=torch.eye(4, device=dev),
            prev_l=prev_l, prev_r=prev_r, prev_lg=lg, prev_rg=rg,
            frame_idx=1,
            dropped=torch.zeros((), dtype=torch.int32, device=dev),
            # far-away origin sentinel: frame 1 always rebuilds
            origin=torch.full((3,), 1 << 20, dtype=torch.int32, device=dev),
            grid=torch.full((self.cfg.n_cells,), -1, dtype=torch.int32,
                            device=dev),
            # empty model render: the ICP fallback cannot associate, so
            # frame 1 falls through to the held motion
            prev_rc_points=torch.zeros(*lg.shape, 3, device=dev),
            prev_rc_hit=torch.zeros(lg.shape, dtype=torch.bool, device=dev),
        )

    def process_frame(self, left_gray, right_gray, rgb=None) -> None:
        """Gray images (H, W) and optional RGB (H, W, 3) uint8, as numpy
        arrays or tensors; they are copied to the device."""
        # no block can reach min_decay_age before frame min_decay_age, so
        # decay is left out until then
        self._frames += 1
        decay_on = self.decay_params.enabled and (
            self._frames >= int(self.decay_params.min_decay_age))
        lg, rg, rgb = upload_frame(left_gray, right_gray, rgb, self.device)
        if self.carry is None:
            self.carry = self._fresh_carry(lg, rg)
            return
        self.carry, self.last_outputs = fused_step(
            self.cfg, self.stereo_params, self.vo_params, decay_on,
            self.carry, lg, rg, rgb, self.calib_vec, self.intr_vec, self.bf,
            float(self.decay_params.max_decay_weight),
            int(self.decay_params.min_decay_age),
            generator=self.generator, sampler=self.sampler)

    # -- accessors (sync on use) ------------------------------------------
    def get_pose(self) -> np.ndarray:
        return self.carry.pose_w2c.cpu().numpy()

    def get_raycast(self) -> Raycast:
        return self.last_outputs.raycast

    def get_used_block_count(self) -> int:
        return int(tsdf.memory_stats(self.cfg, self.carry.state)[0])

    def get_dropped_allocation_count(self) -> int:
        return int(self.carry.dropped)
