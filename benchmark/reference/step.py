"""The fused frame steps in plain PyTorch: frozen copies of
``dynslam_tpu_torch/pipeline/fused.py::fused_step`` (with ``front_end``
and ``static_map``) and ``pipeline/fused_dynamic.py::fused_dynamic_step``
(with ``_fuse_volumes`` and ``crop_origins``), over the reference's own
kernels' plain versions.

``lowp`` is the control of the benchmark's correctness check: the same
step with every layer's float output rounded through bfloat16 (stereo
depth, the flow rows, the camera and object motions, the fused view and
the render), the nearest precision below the float32 that the
configuration states.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import depth as depth_ops
from benchmark.reference import egomotion as ego_ops
from benchmark.reference import features as feat_ops
from benchmark.reference import se3
from benchmark.reference import stereo as stereo_ops
from benchmark.reference import tsdf
from benchmark.reference._util import upload
from benchmark.reference.config import (
    StereoMatcherParams, VisualOdometryParams,
)
from benchmark.reference.icp import icp_track
from benchmark.reference.integrate import integrate, integrate_many
from benchmark.reference.raycast import Raycast, raycast
from benchmark.reference.se3 import inverse


def low(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """``x`` rounded through bfloat16 when ``lowp`` (the control), else
    ``x``."""
    if not lowp or not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(x.dtype)


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
    """The port's profiler range; the reference records none."""
    return contextlib.nullcontext()


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
              sampler: Optional[Sampler] = None, lowp: bool = False
              ) -> FrontEnd:
    """Stereo -> depth, features -> circular match -> LK refine, RANSAC
    egomotion with the ICP fallback; ``carry`` is read, not changed."""
    with _stage("stereo"):
        disp = stereo_ops.compute_disparity(left_gray, right_gray,
                                            stereo_params)
        depth_m = depth_ops.depth_m_from_mm(depth_ops.depth_mm_from_disparity(
            disp, bf, cfg.min_depth, cfg.max_depth))
        depth_m = low(depth_m, lowp)

    with _stage("features"):
        cur_l, cur_r = feat_ops.detect_features_pair(left_gray, right_gray,
                                                     vo_params)
        flow, valid = feat_ops.circular_match(cur_l, cur_r, carry.prev_l,
                                              carry.prev_r, vo_params)
        flow, valid = _refine_matches(left_gray, right_gray, carry.prev_lg,
                                      carry.prev_rg, flow, valid, vo_params)
        flow = low(flow, lowp)
    with _stage("egomotion"):
        est = ego_ops.estimate_motion(
            flow, valid, calib_vec, torch.zeros(6, device=flow.device),
            vo_params, generator=generator,
            sample_ids=None if sampler is None else sampler(carry.frame_idx,
                                                            valid))
        held, syncs = motion_with_icp_fallback(est, carry, depth_m, intr_vec)
        held = low(held, lowp)
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
               max_decay_weight, min_decay_age, lowp: bool = False
               ) -> StaticMap:
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
        rc = rc._replace(depth=low(rc.depth, lowp),
                         points=low(rc.points, lowp))

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
    lowp: bool = False,
):
    """One full frame; returns (carry', FusedOutputs). ``carry.state`` is
    updated in place. RANSAC draws come from ``sampler`` when given, else
    from ``generator``."""
    fe = front_end(cfg, stereo_params, vo_params, carry, left_gray,
                   right_gray, calib_vec, intr_vec, bf, generator, sampler,
                   lowp)
    sm = static_map(cfg, decay_enabled, carry, fe.depth_m, rgb, fe.pose_w2c,
                    intr_vec, max_decay_weight, min_decay_age, lowp)
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



#: silhouette actions (ProcessSilhouette branches,
#: InstanceReconstructor.cpp:226-285)
ACTION_KEEP = 0
ACTION_REMOVE = 1
ACTION_CUT = 2

#: per-mask match rows fed to the object RANSAC (matches past the cap are
#: dropped)
OBJ_MATCH_CAP = 256

class FusedDynCarry(NamedTuple):
    """Cross-frame state, in the JAX package's field order. The static
    fields are ``FusedCarry``'s; ``inst`` is the stacked (S, ...) pool of
    object volumes. Values the host decides stay host numpy: the
    per-slot fusion clock ``inst_fidx`` and the crop origins."""

    state: tsdf.TsdfState
    pose_w2c: torch.Tensor
    held_motion: torch.Tensor
    prev_l: feat_ops.Features
    prev_r: feat_ops.Features
    prev_lg: torch.Tensor
    prev_rg: torch.Tensor
    frame_idx: int
    dropped: torch.Tensor
    origin: torch.Tensor
    grid: torch.Tensor
    prev_rc_points: torch.Tensor  # (H, W, 3) f32
    prev_rc_hit: torch.Tensor  # (H, W) bool
    inst: tsdf.TsdfState  # stacked object volumes, (S, ...) fields
    inst_fidx: np.ndarray  # (S,) int32 per-slot fusion clock (decay age)
    #: views cut this frame — bbox-centred crops, zero outside the copy
    #: mask, with their 4-aligned frame origins (u0, v0); fused by the
    #: next dispatch (lag 1) or the one after (lag 2, from prev_pending_*)
    pending_depth: torch.Tensor  # (K, CH, CW) f32
    pending_rgb: torch.Tensor  # (K, CH, CW, 3) uint8
    pending_org: np.ndarray  # (K, 2) int32
    prev_pending_depth: torch.Tensor
    prev_pending_rgb: torch.Tensor
    prev_pending_org: np.ndarray


class FusedDynOutputs(NamedTuple):
    raycast: Raycast
    depth_m: torch.Tensor
    pose_w2c: torch.Tensor
    #: every scalar the tracker needs, one float64 vector (``pack_layout``)
    packed: torch.Tensor
    #: device -> host syncs the step's host branches took
    host_syncs: int


class Routing(NamedTuple):
    """The host's per-frame inputs of the step (the JAX package packs
    them into one uploaded vector, ``route_layout``)."""

    copy_bbox: np.ndarray  # (K, 4) f32 copy-mask bbox x0, y0, x1, y1
    mask_gate: np.ndarray  # (K,) bool: slot holds a detection
    warm_tr: np.ndarray  # (K, 6) f32 object RANSAC warm starts
    action: np.ndarray  # (K,) int32 ACTION_*
    slot_src: np.ndarray  # (S,) int32 pending crop fused into a slot, -1
    fuse_pose: np.ndarray  # (S, 4, 4) f32 world-to-volume of that fusion
    slot_reset: np.ndarray  # (S,) bool
    slot_reap_w: np.ndarray  # (S,) f32, 0 = no reap
    max_decay_weight: float
    min_decay_age: int


def pack_layout(K: int):
    """(name, offset, size) layout of the packed output vector (the JAX
    package's, without its relay ``sync`` scalar)."""
    off = {}
    cur = 0
    for name, size in [
        ("vo_success", 1), ("vo_inliers", 1),
        ("delta", 16), ("pose", 16),
        ("n_new", 1), ("n_freed", 1), ("dropped", 1),
        ("obj_tr", 6 * K), ("obj_success", K), ("obj_inliers", K),
        ("obj_count", K),
        # voxels in blocks gated into fusion (static + instances) and ray
        # samples the raycast marched
        ("fused_voxels", 1), ("march_samples", 1),
        # post-decay allocated static blocks + cumulative decayed blocks
        ("used_blocks", 1), ("decayed_blocks", 1),
    ]:
        off[name] = (cur, size)
        cur += size
    return off, cur


def _bits_i32(x: torch.Tensor) -> torch.Tensor:
    """Mask bit-planes -> int32 for the slot bit math. uint8/uint16
    zero-extend; uint32 (K > 16 slots) is reinterpreted, never converted,
    so slot 31's bit survives in the sign position."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x.to(torch.int32)


def _i32(bits: int) -> int:
    """A 32-bit mask as a two's-complement int32 value."""
    return bits - (1 << 32) if bits >= 1 << 31 else bits


def crop_origins(copy_bbox: np.ndarray, h: int, w: int, ch: int,
                 cw: int) -> np.ndarray:
    """(K, 2) int32 (u0, v0) of the bbox-centred (ch, cw) crops on the
    frame padded to 4-aligned dims: the centre truncated to int, minus
    half the crop, clipped into the padded frame, then aligned down to 4
    (allocation samples every 4th pixel, so the phase is kept)."""
    hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
    bb = np.asarray(copy_bbox, np.float32)
    u0 = np.clip(((bb[:, 0] + bb[:, 2]) * np.float32(0.5)).astype(np.int32)
                 - cw // 2, 0, wp - cw)
    v0 = np.clip(((bb[:, 1] + bb[:, 3]) * np.float32(0.5)).astype(np.int32)
                 - ch // 2, 0, hp - ch)
    return np.stack([u0 // 4 * 4, v0 // 4 * 4], 1).astype(np.int32)


def _dyn_stage(name: str):
    return contextlib.nullcontext()


def _fuse_volumes(icfg, inst, inst_fidx, slots_to_fuse, depth, rgb, w2c_np,
                  intr_np, inst_decay, max_decay_weight, min_decay_age):
    """Allocate, fuse (one K1 launch over the volume axis) and decay the
    pool slots ``slots_to_fuse`` from their views ``depth`` (n, H, W) and
    ``rgb`` (n, H, W, 3) at world-to-volume poses ``w2c_np`` (n, 4, 4) and
    intrinsics ``intr_np`` (n, 4) (host numpy), in place; advances their
    fusion clocks. Returns the voxels gated into fusion (0-d tensor)."""
    dev = depth.device
    n = len(slots_to_fuse)
    small = upload(np.concatenate(
        [np.asarray(w2c_np, np.float32).reshape(n, 16),
         np.asarray(intr_np, np.float32)], 1), dev)
    w2c = small[:, :16].reshape(n, 4, 4)
    intr4 = small[:, 16:]
    c2w = se3.inverse(w2c)
    vis_slots, vis_masks = [], []
    for i, s in enumerate(slots_to_fuse):
        st = tsdf.pool_slot(inst, s)
        origin = tsdf.compute_origin(icfg, c2w[i])
        grid = tsdf.build_local_grid(icfg, st, origin)
        st, grid, _ = tsdf.allocate(icfg, st, grid, origin, depth[i], c2w[i],
                                    int(inst_fidx[s]), intr4=intr4[i])
        sl, m = tsdf.visible_blocks(icfg, st, grid, origin, w2c[i],
                                    intr4=intr4[i])
        vis_slots.append(sl)
        vis_masks.append(m)
    masks = torch.stack(vis_masks)
    integrate_many(icfg, inst, slots_to_fuse, torch.stack(vis_slots), masks,
                   rgb, depth, w2c, [int(inst_fidx[s]) for s in slots_to_fuse],
                   intr4)
    for s in slots_to_fuse:
        if inst_decay:
            tsdf.decay(icfg, tsdf.pool_slot(inst, s), int(inst_fidx[s]) + 1,
                       max_decay_weight, min_decay_age)
        inst_fidx[s] += 1
    return masks.sum(dtype=torch.int64) * tsdf.BLOCK3


def fused_dynamic_step(
    cfg: tsdf.TsdfConfig,
    icfg: tsdf.TsdfConfig,  # instance configuration at the crop size
    stereo_params,
    vo_params: VisualOdometryParams,
    obj_params: VisualOdometryParams,
    decay_enabled: bool,
    inst_decay: bool,
    K: int,  # mask slots
    S: int,  # pooled volume slots
    carry: FusedDynCarry,
    left_gray: torch.Tensor,  # (H, W) f32
    right_gray: torch.Tensor,  # (H, W) f32
    rgb: torch.Tensor,  # (H, W, 3) uint8
    delete_bits: torch.Tensor,  # (H, W) int32, bit j = delete mask j
    copy_bits: torch.Tensor,  # (H, W) int32, bit j = copy mask j
    routing: Routing,
    calib_vec: torch.Tensor,
    intr_vec: torch.Tensor,
    intr_host: np.ndarray,  # (4,) f32 fx, fy, cx, cy
    bf: float,
    generator: Optional[torch.Generator] = None,
    sampler: Optional[Sampler] = None,
    fuse_from_prev: bool = False,
    lowp: bool = False,
):
    """One dynamic frame: returns (carry', FusedDynOutputs). The static map
    and the object pool are updated in place.

    ``fuse_from_prev`` (the lag-2 protocol) fuses the one-frame-older
    pending crops. ``sampler(frame_idx, valid)`` replaces the generator's
    RANSAC draws: for the camera ``valid`` is (N,) and it returns
    (iters, 3); for the object masks ``valid`` is (n, OBJ_MATCH_CAP) over
    the first n mask slots and it returns (n, iters, 3)."""
    h, w = left_gray.shape
    dev = left_gray.device
    fe = front_end(cfg, stereo_params, vo_params, carry, left_gray,
                   right_gray, calib_vec, intr_vec, bf, generator, sampler,
                   lowp)
    flow, valid, depth_m = fe.flow, fe.valid, fe.depth_m

    # --- per-mask object motion (ExtractSceneFlow + ExtractMotion roles,
    # InstanceReconstructor.cpp:802-849); masks past the live ones hold no
    # detection, so their estimate is the failed one and is not run
    with _dyn_stage("obj_ransac"):
        live = np.flatnonzero(routing.mask_gate)
        n_live = int(live[-1]) + 1 if live.size else 0
        obj_tr = torch.zeros(K, 6, device=dev)
        obj_success = torch.zeros(K, dtype=torch.bool, device=dev)
        obj_inliers = torch.zeros(K, dtype=torch.int64, device=dev)
        obj_count = torch.zeros(K, dtype=torch.int64, device=dev)
        if n_live:
            small = upload(np.concatenate(
                [routing.copy_bbox[:n_live], routing.warm_tr[:n_live],
                 routing.mask_gate[:n_live, None]], 1).astype(np.float32),
                dev)
            bb, warm, gate = small[:, :4], small[:, 4:10], small[:, 10] > 0.5
            ui = torch.clamp(torch.round(flow[:, 0]), 0, w - 1).long()
            vi = torch.clamp(torch.round(flow[:, 1]), 0, h - 1).long()
            bits_at = delete_bits[vi, ui]  # one gather for every mask
            jj = torch.arange(n_live, dtype=torch.int32, device=dev)
            up, vp = flow[:, 4], flow[:, 5]
            sel = (((bits_at[None] >> jj[:, None]) & 1) == 1) \
                & (up >= bb[:, 0:1]) & (up <= bb[:, 2:3]) \
                & (vp >= bb[:, 1:2]) & (vp <= bb[:, 3:4])
            valid_j = valid[None] & sel & gate[:, None]
            count = valid_j.sum(-1)
            # each mask's matches compacted to OBJ_MATCH_CAP rows
            idx = tsdf.compact_mask(valid_j, OBJ_MATCH_CAP, 0)
            vmask = torch.arange(OBJ_MATCH_CAP, device=dev)[None] \
                < count[:, None]
            est = ego_ops.estimate_motion_many(
                flow[idx], vmask, calib_vec, warm, obj_params,
                generator=generator,
                sample_ids=None if sampler is None
                else sampler(carry.frame_idx, vmask))
            obj_tr[:n_live] = low(est.tr, lowp)
            obj_success[:n_live] = est.success
            obj_inliers[:n_live] = est.num_inliers
            obj_count[:n_live] = count

    # --- fuse the pending crops routed to the pooled object volumes ------
    with _dyn_stage("instances"):
        if fuse_from_prev:
            fd, fr, fo = (carry.prev_pending_depth, carry.prev_pending_rgb,
                          carry.prev_pending_org)
        else:
            fd, fr, fo = (carry.pending_depth, carry.pending_rgb,
                          carry.pending_org)
        inst_fidx = carry.inst_fidx.copy()
        inst_nvox = torch.zeros((), dtype=torch.int64, device=dev)
        fresh = None
        act = []
        for s in range(S):
            st = tsdf.pool_slot(carry.inst, s)
            if routing.slot_reset[s]:
                if fresh is None:
                    fresh = tsdf.create_state(icfg, dev)
                tsdf.assign_state(st, fresh)
                inst_fidx[s] = 0
            if routing.slot_reap_w[s] > 0:
                # stale-track aggressive decay (Track::ReapReconstruction,
                # Track.h:222-229): every voxel of weight <= reap_w goes
                tsdf.decay(icfg, st, int(inst_fidx[s]),
                           float(routing.slot_reap_w[s]), 0, force_all=True)
            if routing.slot_src[s] >= 0:
                act.append(s)
        if act:
            src = [int(np.clip(routing.slot_src[s], 0, K - 1)) for s in act]
            intr = np.stack([intr_host - np.asarray(
                [0, 0, fo[j, 0], fo[j, 1]], np.float32) for j in src])
            inst_nvox = _fuse_volumes(
                icfg, carry.inst, inst_fidx, act,
                low(torch.stack([fd[j] for j in src]), lowp),
                torch.stack([fr[j] for j in src]),
                routing.fuse_pose[act], intr, inst_decay,
                routing.max_decay_weight, routing.min_decay_age)

    # --- silhouette cut: removed pixels leave the static view; CUT slots
    # copy their crop into the pending buffer -----------------------------
    with _dyn_stage("cut"):
        action = np.asarray(routing.action)
        rem = sum(1 << j for j in range(K) if action[j] >= ACTION_REMOVE)
        if rem:
            removed = (delete_bits & _i32(rem)) != 0
            depth_cut = torch.where(removed, 0.0, depth_m)
            rgb_cut = torch.where(removed[..., None], 0, rgb).to(torch.uint8)
        else:
            depth_cut, rgb_cut = depth_m, rgb
        ch, cw = carry.pending_depth.shape[1:]
        org = crop_origins(routing.copy_bbox, h, w, ch, cw)
        pend_d = torch.zeros(K, ch, cw, device=dev)
        pend_rgb = torch.zeros(K, ch, cw, 3, dtype=torch.uint8, device=dev)
        cut = np.flatnonzero(action == ACTION_CUT)
        if cut.size:
            # pad to 4-aligned frame dims so that aligned windows reach the
            # bottom and right edges; zero depth never allocates or fuses
            hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
            depth_c = F.pad(depth_m, (0, wp - w, 0, hp - h))
            rgb_c = F.pad(rgb, (0, 0, 0, wp - w, 0, hp - h))
            cbits_c = F.pad(copy_bits, (0, wp - w, 0, hp - h))
            dbits_c = F.pad(delete_bits, (0, wp - w, 0, hp - h))
            for j in cut:
                u0, v0 = (int(v) for v in org[j])
                win = (slice(v0, v0 + ch), slice(u0, u0 + cw))
                sel = ((cbits_c[win] >> int(j)) & 1) == 1
                # sequential-cut exclusivity: pixels an earlier removing
                # slot's delete mask covers were already deleted when the
                # reference reached this track's copy
                # (ProcessSilhouette_CPU order, InstanceReconstructor.cpp:
                # 59-170), so each overlapped pixel lands in one view
                earlier = rem & ((1 << int(j)) - 1)
                if earlier:
                    sel &= (dbits_c[win] & earlier) == 0
                pend_d[j] = torch.where(sel, depth_c[win], 0.0)
                pend_rgb[j] = torch.where(sel[..., None], rgb_c[win], 0)

    # --- static mapping on the cut view -----------------------------------
    with _dyn_stage("static"):
        sm = static_map(cfg, decay_enabled, carry, depth_cut, rgb_cut,
                        fe.pose_w2c, intr_vec, routing.max_decay_weight,
                        routing.min_decay_age, lowp)
    rc = sm.raycast
    dropped = carry.dropped + sm.n_drop
    carry2 = FusedDynCarry(
        state=sm.state, pose_w2c=fe.pose_w2c, held_motion=fe.held,
        prev_l=fe.cur_l, prev_r=fe.cur_r, prev_lg=left_gray,
        prev_rg=right_gray, frame_idx=carry.frame_idx + 1, dropped=dropped,
        origin=sm.origin, grid=sm.grid, prev_rc_points=rc.points,
        prev_rc_hit=rc.hit, inst=carry.inst, inst_fidx=inst_fidx,
        pending_depth=pend_d, pending_rgb=pend_rgb, pending_org=org,
        prev_pending_depth=carry.pending_depth,
        prev_pending_rgb=carry.pending_rgb,
        prev_pending_org=carry.pending_org,
    )
    d64 = torch.float64
    packed = torch.cat([
        fe.est.success.to(d64)[None], fe.est.num_inliers.to(d64)[None],
        fe.held.reshape(-1).to(d64), fe.pose_w2c.reshape(-1).to(d64),
        sm.n_new.to(d64)[None], sm.n_freed.to(d64)[None],
        dropped.to(d64)[None],
        obj_tr.reshape(-1).to(d64), obj_success.to(d64),
        obj_inliers.to(d64), obj_count.to(d64),
        (sm.mask.sum(dtype=torch.int64) * tsdf.BLOCK3 + inst_nvox)
        .to(d64)[None],
        rc.march_samples.to(d64)[None],
        tsdf.memory_stats(cfg, sm.state)[0].to(d64)[None],
        sm.state.decayed_blocks.to(d64)[None],
    ])
    outs = FusedDynOutputs(raycast=rc, depth_m=depth_m, pose_w2c=fe.pose_w2c,
                           packed=packed,
                           host_syncs=fe.host_syncs + sm.host_syncs)
    return carry2, outs


