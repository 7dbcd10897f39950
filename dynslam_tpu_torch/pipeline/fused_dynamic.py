"""The dynamic-object frame step — the port of
``dynslam_tpu/pipeline/fused_dynamic.py``, the reference's default mode
(DynSLAMGUI.cpp:26-31), with its in-loop evaluation (``_stash_eval``,
``_flush_eval``: the static render with each object volume composited in,
a crop-viewport render where the object fits the fusion crop).

Per frame (``fused_dynamic_step``):

  stereo -> features/flow -> camera RANSAC (the static step's front end)
  -> per-mask object RANSAC, batched over the live mask slots -> the
  silhouette cut into bbox-centred crops -> fusion of the routed pending
  crops into the S pooled object volumes (one K1 launch over the volume
  axis) -> static allocate + fuse (K1) + raycast (K2) + decay on the cut
  view -> one packed output vector.

The host tracker (``FusedDynamicPipeline``) runs the reference tracker one
frame behind, as the JAX package does: association before the dispatch,
a speculative cut while a track is Uncertain, ``Track.update`` with the
device's motions after it, and slot allocation, reset, reap and routing
of the pending crops into a later dispatch. ``dispatch_lag`` 2 dispatches
frame k before it finishes frame k-1.

What differs from the TPU design: every routing input is host numpy and
is read on the host (crop origins, which volumes have work, poses); small
device inputs go up through pinned memory without a host sync; per-slot
allocate, visibility, reset, reap and decay run only for slots with work;
the packed outputs come back once a frame with one non-blocking copy into
pinned memory and a CUDA event that ``_finish_one`` waits on. The pool and
the static map are updated in place.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynslam_tpu_torch.config import (
    DynSlamConfig, StereoCalibration, VisualOdometryParams,
)
from dynslam_tpu_torch.device import DeviceLike, resolve_device, upload
from dynslam_tpu_torch.eval.evaluation import (
    ASSOC_DYNAMIC, ASSOC_SKIP, build_association_map,
)
from dynslam_tpu_torch.instances.track import Track, TrackFrame, TrackState
from dynslam_tpu_torch.instances.tracker import InstanceTracker
from dynslam_tpu_torch.io.segmentation import InstanceDetection
from dynslam_tpu_torch.ops import egomotion as ego_ops
from dynslam_tpu_torch.ops import features as feat_ops
from dynslam_tpu_torch.ops import masks as mask_ops
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.ops.integrate import integrate_many
from dynslam_tpu_torch.ops.raycast import Raycast, raycast
from dynslam_tpu_torch.pipeline.fused import (
    Sampler, front_end, static_map, upload_frame,
)
from dynslam_tpu_torch.utils import se3

#: silhouette actions (ProcessSilhouette branches,
#: InstanceReconstructor.cpp:226-285)
ACTION_KEEP = 0
ACTION_REMOVE = 1
ACTION_CUT = 2

#: per-mask match rows fed to the object RANSAC (matches past the cap are
#: dropped)
OBJ_MATCH_CAP = 256

#: the GUI's track tints (tab10), for ``composited_preview``
PALETTE = np.array(
    [
        [0x1F, 0x77, 0xB4], [0xFF, 0x7F, 0x0E], [0x2C, 0xA0, 0x2C],
        [0xD6, 0x27, 0x28], [0x94, 0x67, 0xBD], [0x8C, 0x56, 0x4B],
        [0xE3, 0x77, 0xC2], [0x7F, 0x7F, 0x7F], [0xBC, 0xBD, 0x22],
        [0x17, 0xBE, 0xCF],
    ],
    dtype=np.float32,
)


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


def assoc_bits_to_map(copy_bits: torch.Tensor, codes: torch.Tensor,
                      k: int) -> torch.Tensor:
    """The segmented evaluation's association map from the frame's
    copy-mask bit-planes (bit j = mask slot j; uint8/16/32 planes or
    their int32 form) and the (K,) int8 codes of the slots: at each pixel
    the code of the last slot whose bit is set, 0 where none is — the
    device form of ``build_association_map`` over the K selected
    detections, whose host loop lets later detections overwrite earlier
    ones."""
    bits = copy_bits if copy_bits.dtype == torch.int32 \
        else _bits_i32(copy_bits)
    j = torch.arange(k, dtype=torch.int32, device=bits.device)
    hit = ((bits[..., None] >> j) & 1) == 1
    # 1 + the last slot set, 0 = none
    last = torch.where(hit, (j + 1).to(torch.int8), 0).amax(-1)
    table = torch.cat([torch.zeros(1, dtype=torch.int8, device=bits.device),
                       codes.to(torch.int8)])
    return table[last.to(torch.int64)]


def merge_crop_depth(target: torch.Tensor, crop: torch.Tensor, v0: int,
                     u0: int) -> None:
    """Z-merge a crop render into ``target`` at (v0, u0), in place: the
    nearest-wins rule of ``masks.composite_depth``."""
    ch, cw = crop.shape
    win = target[v0:v0 + ch, u0:u0 + cw]
    win.copy_(mask_ops.composite_depth(win, crop))


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
    """A named range for torch.profiler, like ``fused.py``'s ``_stage``."""
    return torch.profiler.record_function(f"fused_dyn.{name}")


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


def fuse_slot_fullframe(icfg, inst_decay, inst, inst_fidx, slot, depth_m,
                        rgb, mask, w2c, reset, intr_host, max_decay_weight,
                        min_decay_age) -> None:
    """Full-frame fusion of one pooled slot — the oversized-mask path: a
    mask whose bbox exceeds the fusion crop would lose its out-of-crop
    pixels, where the reference fuses the full masked view
    (InstanceReconstructor.cpp:569-700). ``icfg`` is the full-frame
    instance configuration; ``mask`` (H, W) bool, ``w2c`` (4, 4) and
    ``intr_host`` (4,) are host numpy. In place."""
    dev = depth_m.device
    if reset:
        tsdf.assign_state(tsdf.pool_slot(inst, slot),
                          tsdf.create_state(icfg, dev))
        inst_fidx[slot] = 0
    m = upload(mask, dev)
    d = torch.where(m, depth_m, 0.0)
    rgbm = torch.where(m[..., None], rgb, 0).to(torch.uint8)
    _fuse_volumes(icfg, inst, inst_fidx, [slot], d[None], rgbm[None],
                  np.asarray(w2c, np.float32)[None],
                  np.asarray(intr_host, np.float32)[None], inst_decay,
                  max_decay_weight, min_decay_age)


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
                   right_gray, calib_vec, intr_vec, bf, generator, sampler)
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
            obj_tr[:n_live] = est.tr
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
                torch.stack([fd[j] for j in src]),
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
                        routing.min_decay_age)
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


class _SlotHandle:
    """Track.reconstruction adapter over one pooled slot. Resets and reaps
    are scheduled into the next dispatch's routing."""

    def __init__(self, pipeline: "FusedDynamicPipeline", slot: int):
        self.pipeline = pipeline
        self.slot = slot
        self.fused_frames = 0

    @property
    def cfg(self) -> tsdf.TsdfConfig:
        return self.pipeline.icfg

    @property
    def state(self) -> tsdf.TsdfState:
        return tsdf.pool_slot(self.pipeline.carry.inst, self.slot)

    def get_raycast(self, cam_to_world) -> Raycast:
        return self.pipeline.raycast_instance(self.slot, cam_to_world)

    def reset(self) -> None:
        if self.pipeline.verbose_tracker:
            print(f"[tracker] slot {self.slot}: RESET routed",
                  file=sys.stderr)
        self.pipeline._route_reset[self.slot] = True
        self.fused_frames = 0

    def reap(self, max_weight: float) -> None:
        if self.pipeline.verbose_tracker:
            print(f"[tracker] slot {self.slot}: REAP w<={max_weight}",
                  file=sys.stderr)
        self.pipeline._route_reap[self.slot] = float(max_weight)

    def release(self) -> None:
        self.pipeline._free_slots.append(self.slot)

    def get_used_block_count(self) -> int:
        return int(tsdf.memory_stats(self.pipeline.icfg, self.state)[0])


class FusedDynamicPipeline:
    """Host wrapper: one step per frame, the reference tracker running one
    frame behind on the packed outputs.

    ``dispatch_lag`` 1 finishes frame k-1 (waits for its packed outputs)
    before it dispatches frame k; 2 dispatches frame k first, so the host
    waits on frame k-1 while the card runs frame k. Tracker decisions then
    go one frame staler and each cut view fuses one dispatch later (the
    pending buffer is two deep); the speculative Uncertain-cut keeps the
    transition frames' views."""

    def __init__(
        self,
        config: DynSlamConfig,
        calib: StereoCalibration,
        cfg: tsdf.TsdfConfig,  # the static map
        icfg: tsdf.TsdfConfig,  # an object volume, full frame
        icfg_fuse: tsdf.TsdfConfig,  # an object volume, at the crop size
        obj_params: VisualOdometryParams,
        K: int,
        S: int,
        device: DeviceLike = None,
        seed: int = 0,
        dispatch_lag: int = 2,
        sampler: Optional[Sampler] = None,
    ):
        if dispatch_lag not in (1, 2):
            raise ValueError(f"dispatch_lag must be 1 or 2, not {dispatch_lag}")
        if K > 32:
            raise ValueError(f"{K} mask slots: the bit-planes hold at most 32")
        self.dispatch_lag = dispatch_lag
        self.config = config
        self.cfg, self.icfg, self.icfg_fuse = cfg, icfg, icfg_fuse
        self.crop_h, self.crop_w = icfg_fuse.height, icfg_fuse.width
        self.stereo_params = config.stereo
        self.vo_params = config.vo
        self.obj_params = obj_params
        self.decay_params = config.decay
        self.K, self.S = K, S
        self._layout, self._packed_len = pack_layout(K)
        self.device = resolve_device(device)
        dev = self.device
        self.calib_vec = torch.tensor(
            [cfg.fx, cfg.cx, cfg.cy, calib.baseline_m], device=dev)
        self.intr_host = np.asarray([cfg.fx, cfg.fy, cfg.cx, cfg.cy],
                                    np.float32)
        self.intr_vec = torch.tensor(self.intr_host, device=dev)
        self.bf = calib.bf
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.sampler = sampler

        self.tracker = InstanceTracker(config.tracker)
        #: log slot resets, reaps and track state transitions to stderr
        self.verbose_tracker = False
        self._free_slots: List[int] = list(range(S))
        self.carry: Optional[FusedDynCarry] = None
        self.last_outputs: Optional[FusedDynOutputs] = None
        self.current_frame_no = 0
        self.pose_history: List[np.ndarray] = [np.eye(4, dtype=np.float32)]
        #: the unfinished dispatch: (frame_no, [(j, track, tf, idx)],
        #: {track_id: j}, detections, outputs, extra, packed fetch)
        self._dispatch_meta = None
        self._reset_routing()
        self._dropped_detections = 0
        #: cut masks whose bbox exceeded the fusion crop (each fused by the
        #: full-frame fallback or truncated, per oversize_mask_fallback)
        self.oversize_masks = 0
        #: copy-mask pixels lost to crop truncation (fallback off only)
        self.truncated_pixels = 0
        #: host syncs of the last dispatched step plus its packed fetch
        self.last_host_syncs = 0
        #: the evaluation's render viewport for object volumes: the
        #: crop configuration, None where the crop is the whole frame
        self.icfg_render = icfg_fuse if (self.crop_h, self.crop_w) != (
            cfg.height, cfg.width) else None
        #: ``eval.fused_eval.FusedEvaluation`` (``builder.
        #: attach_evaluation``) or None; driven from the tracker pass, as
        #: the reference evaluates inside its frame loop
        #: (DynSlam.cpp:154-161)
        self.evaluation = None
        #: the last finished frame's eval payload, rendered once the
        #: dispatch that fuses that frame's views has run
        self._eval_pending = None
        #: frames past this one are finalize()'s fusion-only replays,
        #: never evaluated
        self._final_frame = None
        #: object renders of the evaluation: crop viewports and full frames
        self.eval_crop_renders = 0
        self.eval_full_renders = 0

    # ------------------------------------------------------------------
    def _reset_routing(self) -> None:
        S = self.S
        self._route_src = np.full(S, -1, np.int32)
        self._route_pose = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
        self._route_reset = np.zeros(S, bool)
        self._route_reap = np.zeros(S, np.float32)

    def _fresh_carry(self, lg, rg) -> FusedDynCarry:
        prev_l, prev_r = feat_ops.detect_features_pair(lg, rg, self.vo_params)
        dev = self.device
        K, ch, cw = self.K, self.crop_h, self.crop_w
        return FusedDynCarry(
            state=tsdf.create_state(self.cfg, dev),
            pose_w2c=torch.eye(4, device=dev),
            held_motion=torch.eye(4, device=dev),
            prev_l=prev_l, prev_r=prev_r, prev_lg=lg, prev_rg=rg,
            frame_idx=1,
            dropped=torch.zeros((), dtype=torch.int32, device=dev),
            origin=torch.full((3,), 1 << 20, dtype=torch.int32, device=dev),
            grid=torch.full((self.cfg.n_cells,), -1, dtype=torch.int32,
                            device=dev),
            prev_rc_points=torch.zeros(*lg.shape, 3, device=dev),
            prev_rc_hit=torch.zeros(lg.shape, dtype=torch.bool, device=dev),
            inst=tsdf.create_pool(self.icfg, self.S, dev),
            inst_fidx=np.zeros(self.S, np.int32),
            pending_depth=torch.zeros(K, ch, cw, device=dev),
            pending_rgb=torch.zeros(K, ch, cw, 3, dtype=torch.uint8,
                                    device=dev),
            pending_org=np.zeros((K, 2), np.int32),
            prev_pending_depth=torch.zeros(K, ch, cw, device=dev),
            prev_pending_rgb=torch.zeros(K, ch, cw, 3, dtype=torch.uint8,
                                         device=dev),
            prev_pending_org=np.zeros((K, 2), np.int32),
        )

    # ------------------------------------------------------------------
    @staticmethod
    def select_detections(
        detections: List[InstanceDetection], k: int
    ) -> List[InstanceDetection]:
        """Possibly-dynamic detections, largest-first capped at the K mask
        slots."""
        cands = [d for d in detections if d.is_possibly_dynamic()]
        if len(cands) > k:
            cands.sort(key=lambda d: d.copy_mask.bbox.area, reverse=True)
            cands = cands[:k]
        return cands

    @staticmethod
    def pack_mask_bits(
        detections: List[InstanceDetection], h: int, w: int, k: int = 8
    ) -> "tuple[np.ndarray, np.ndarray]":
        """(delete_bits, copy_bits) bit-planes of already-selected
        detections (bit j = slot j) in the narrowest dtype that fits:
        uint8 up to 8 detections, uint16 to 16, uint32 to 32."""
        if k > 32:
            raise ValueError("mask bit-planes support at most 32 slots")
        n = min(len(detections), k)
        dt = np.uint8 if n <= 8 else (np.uint16 if n <= 16 else np.uint32)
        delete_bits = np.zeros((h, w), dt)
        copy_bits = np.zeros((h, w), dt)
        for j, det in enumerate(detections):
            delete_bits |= (
                det.delete_mask.to_full_frame(h, w).astype(dt) << dt(j)
            )
            if det.is_reconstructable():
                copy_bits |= (
                    det.copy_mask.to_full_frame(h, w).astype(dt) << dt(j)
                )
        return delete_bits, copy_bits

    def mask_exceeds_crop(self, det, h: int, w: int) -> bool:
        """Whether the bbox-centred fusion crop (``crop_origins``) loses
        pixels of the detection's copy mask, i.e. takes the full-frame
        fallback."""
        bb = det.copy_mask.bbox
        u0, v0 = crop_origins(np.asarray([[bb.x0, bb.y0, bb.x1, bb.y1]]),
                              h, w, self.crop_h, self.crop_w)[0]
        return not (bb.x0 >= u0 and bb.x1 <= u0 + self.crop_w - 1
                    and bb.y0 >= v0 and bb.y1 <= v0 + self.crop_h - 1)

    def _track_of_frame(self, tf: TrackFrame) -> Track:
        for track in self.tracker.active_tracks.values():
            if track.frames and track.frames[-1] is tf:
                return track
        raise AssertionError("frame not associated")

    def process_frame(self, left_gray, right_gray, rgb=None,
                      detections: Optional[List[InstanceDetection]] = None,
                      masks_dev=None) -> None:
        """One frame: gray images (H, W) and optional RGB (H, W, 3) uint8,
        numpy or tensors, and the frame's instance detections (host
        data). ``masks_dev``, when given, is the (delete_bits, copy_bits)
        pair of ``pack_mask_bits`` planes of the same ``select_detections``
        subset, already on the device (the bench's segmentation worker
        packs and uploads them a frame ahead); the step then skips its own
        packing and upload."""
        detections = detections or []
        dev = self.device
        lg, rg, rgb = upload_frame(left_gray, right_gray, rgb, dev)

        if self.carry is None:
            # frame 0: features only, no flow yet; its pose is identity
            self.carry = self._fresh_carry(lg, rg)
            self.pose_history.append(np.eye(4, dtype=np.float32))
            self.current_frame_no = 1
            return

        if self.dispatch_lag == 1:
            self._finish_prev()

        with _dyn_stage("associate"):
            frame_no = self.current_frame_no
            h, w = self.cfg.height, self.cfg.width

            # associate this frame's detections (bbox/class only, Track.cpp:
            # 17-71 needs no flow)
            n_dyn = sum(1 for d in detections if d.is_possibly_dynamic())
            dropped_now = max(0, n_dyn - self.K)
            self._dropped_detections += dropped_now
            if dropped_now:
                print(f"[frame {frame_no}: {dropped_now} detections over the "
                      f"{self.K} mask slots dropped (largest-first kept)]",
                      file=sys.stderr)
            cands = self.select_detections(detections, self.K)
            new_frames = [
                TrackFrame(frame_idx=frame_no, detection=det,
                           masked_flow=np.zeros((0, 8), np.float32),
                           camera_pose=self.pose_history[-1])
                for det in cands
            ]
            self.tracker.process_instance_views(frame_no, new_frames)

            # per-slot actions from the current (frame k-1-updated) states
            assoc = []
            pending_j: Dict[int, int] = {}
            copy_bbox = np.zeros((self.K, 4), np.float32)
            mask_gate = np.zeros(self.K, bool)
            warm_tr = np.zeros((self.K, 6), np.float32)
            action = np.zeros(self.K, np.int32)
            #: copy-mask pixels the fusion crop would lose, per slot
            trunc_px = np.zeros(self.K, np.int64)
            always = self.config.always_reconstruct_objects
            for j, tf in enumerate(new_frames):
                track = self._track_of_frame(tf)
                det = tf.detection
                assoc.append((j, track, tf, len(track.frames) - 1))
                bb = det.copy_mask.bbox
                copy_bbox[j] = (bb.x0, bb.y0, bb.x1, bb.y1)
                mask_gate[j] = True
                # warm start from the latest frame with a known twist (at lag
                # 2 the immediately-previous frame's update is pending)
                for f in reversed(track.frames[:-1]):
                    if f.relative_pose_tr is not None:
                        warm_tr[j] = f.relative_pose_tr
                        break
                if track.state == TrackState.UNCERTAIN \
                        or track.state == TrackState.DYNAMIC or always:
                    # Uncertain: a SPECULATIVE cut, the same view removal, so
                    # that a track certified at this very frame by the
                    # deferred pass still fuses the transition frame's view
                    if det.is_reconstructable():
                        act = ACTION_CUT
                    elif det.is_possibly_dynamic():
                        act = ACTION_REMOVE
                    else:
                        act = ACTION_KEEP
                else:  # Static without always_reconstruct: stays in the view
                    act = ACTION_KEEP
                action[j] = act
                if act == ACTION_CUT:
                    pending_j[track.id] = j
                    if self.mask_exceeds_crop(det, h, w):
                        u0, v0 = crop_origins(copy_bbox[j:j + 1], h, w,
                                              self.crop_h, self.crop_w)[0]
                        full = det.copy_mask.to_full_frame(h, w)
                        inside = full[v0: v0 + self.crop_h,
                                      u0: u0 + self.crop_w].sum()
                        trunc_px[j] = int(full.sum()) - int(inside)

            if masks_dev is not None:
                delete_bits, copy_bits = (_bits_i32(x) for x in masks_dev)
            else:
                db, cb = self.pack_mask_bits(cands, h, w, self.K)
                both = _bits_i32(upload(np.stack([db, cb]), dev))
                delete_bits, copy_bits = both[0], both[1]

            routing = Routing(
                copy_bbox=copy_bbox, mask_gate=mask_gate, warm_tr=warm_tr,
                action=action, slot_src=self._route_src,
                fuse_pose=self._route_pose, slot_reset=self._route_reset,
                slot_reap_w=self._route_reap,
                max_decay_weight=float(self.decay_params.max_decay_weight),
                min_decay_age=int(self.decay_params.min_decay_age),
            )
        prev_meta = self._dispatch_meta
        self.carry, self.last_outputs = fused_dynamic_step(
            self.cfg, self.icfg_fuse, self.stereo_params, self.vo_params,
            self.obj_params,
            self.decay_params.enabled
            and frame_no >= int(self.decay_params.min_decay_age),
            self.decay_params.enabled, self.K, self.S,
            self.carry, lg, rg, rgb, delete_bits, copy_bits, routing,
            self.calib_vec, self.intr_vec, self.intr_host, self.bf,
            generator=self.generator, sampler=self.sampler,
            fuse_from_prev=self.dispatch_lag == 2,
        )
        self._dispatch_meta = (
            frame_no, assoc, pending_j, detections, self.last_outputs,
            {"trunc_px": trunc_px, "action": action, "cands": cands,
             "rgb": rgb, "copy_bits": copy_bits},
            self._fetch_packed(self.last_outputs.packed),
        )
        self.last_host_syncs = self.last_outputs.host_syncs + 1
        self._reset_routing()
        self.current_frame_no += 1
        # the staged eval needed this dispatch's object fusions: render it
        # now, before the lag-2 tracker pass below stages the next frame
        self._flush_eval()
        if self.dispatch_lag == 2 and prev_meta is not None:
            # the card is busy with frame k: finish frame k-1 now; its
            # routing lands in the next dispatch
            self._finish_one(prev_meta)

    @staticmethod
    def _fetch_packed(packed: torch.Tensor):
        """Start the packed vector's copy to the host: (host tensor,
        event) on a CUDA device, the tensor itself on the CPU."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _exclusive_copy_mask(extra, j, h: int, w: int) -> np.ndarray:
        """Slot j's full-frame copy mask minus earlier removing slots'
        delete masks — the step's sequential-cut exclusivity, on the
        host (oversized-mask fallback only)."""
        cands, action = extra["cands"], extra["action"]
        full = cands[j].copy_mask.to_full_frame(h, w).astype(bool)
        for i in range(j):
            if action[i] >= ACTION_REMOVE:
                full &= ~cands[i].delete_mask.to_full_frame(h, w)
        return full

    # ------------------------------------------------------------------
    def _finish_prev(self) -> None:
        """Finish the latest unfinished dispatch (lag 1's per-frame entry
        point; also the flush of ``finalize``)."""
        if self._dispatch_meta is None:
            return
        meta = self._dispatch_meta
        self._dispatch_meta = None
        self._finish_one(meta)
        if self.dispatch_lag == 1:
            self.last_outputs = None

    def _finish_one(self, meta) -> None:
        """The reference tracker for one finished frame: Track.update with
        the device's motions, then the ProcessReconstructions bookkeeping
        (InstanceReconstructor.cpp:315-361) that routes pending-crop
        fusion into a later dispatch. Updates target the frame captured
        at dispatch — at lag 2 a newer frame may already be associated on
        the same track."""
        frame_no, assoc, pending_j, dets, outputs, extra, fetch = meta
        host, event = fetch
        # the packed fetch: where the host waits for the dispatch's device
        # work
        with _dyn_stage("fetch_wait"):
            if event is not None:
                event.synchronize()
        with _dyn_stage("tracker"):
            packed = host.numpy()
            L = self._layout

            def get(name):
                o, n = L[name]
                return packed[o: o + n]

            delta = get("delta").reshape(4, 4)
            egomotion = np.linalg.inv(delta).astype(np.float32)
            pose = get("pose").reshape(4, 4).astype(np.float32)
            self.pose_history.append(pose)
            self.last_egomotion = egomotion
            self.last_vo_success = bool(get("vo_success")[0] > 0.5)
            self.last_vo_inliers = int(get("vo_inliers")[0])
            obj_tr = get("obj_tr").reshape(self.K, 6).astype(np.float32)
            obj_success = get("obj_success") > 0.5
            obj_count = get("obj_count").astype(int)
            self.last_fused_voxels = int(get("fused_voxels")[0])
            self.last_march_samples = int(get("march_samples")[0])

            min_flow = self.config.tracker.min_flow_vectors
            for j, track, tf, _idx in assoc:
                if track.id not in self.tracker.tracks:
                    continue  # pruned since dispatch (lag-2 ordering)
                # association ran before this frame's pose was known
                tf.camera_pose = pose
                if obj_success[j] and obj_count[j] >= min_flow:
                    T = se3.np_twist_to_transform(obj_tr[j])
                    tf.precomputed_motion = (T, obj_tr[j].copy())
                else:
                    tf.precomputed_motion = (None, None)
                old_state = track.state
                track.update(egomotion, None, frame=tf)
                if self.verbose_tracker and track.state != old_state:
                    print(f"[tracker] frame {frame_no} track {track.id}: "
                          f"{old_state.value} -> {track.state.value} "
                          f"(flow {int(obj_count[j])}, "
                          f"ok {bool(obj_success[j])})", file=sys.stderr)

            # ProcessReconstructions, with fusion routed into a later dispatch
            fmap = {track.id: (j, tf, idx) for j, track, tf, idx in assoc}
            for track in list(self.tracker.active_tracks.values()):
                ent = fmap.get(track.id)
                det_frame = ent[1] if ent is not None else (
                    track.frames[-1] if track.frames else None)
                if det_frame is None or \
                        not det_frame.detection.is_reconstructable():
                    continue
                if ent is None:
                    # no detection at frame_no: the stale-track reap path (at
                    # lag 2 the track may already hold a newer frame)
                    seen = [f.frame_idx for f in track.frames
                            if f.frame_idx <= frame_no]
                    if not seen:
                        continue
                    gap = frame_no - max(seen)
                    if track.needs_cleanup and track.has_reconstruction() \
                            and gap >= 2:
                        track.reap_reconstruction()
                        track.needs_cleanup = False
                    continue
                j, tf, idx = ent
                if not track.has_reconstruction():
                    eligible = track.eligible_for_reconstruction() and (
                        track.state == TrackState.DYNAMIC
                        or (track.state == TrackState.STATIC
                            and self.config.always_reconstruct_objects))
                    if eligible and self._free_slots:
                        slot = self._free_slots.pop()
                        track.reconstruction = _SlotHandle(self, slot)
                        self._route_reset[slot] = True
                if track.has_reconstruction() and track.id in pending_j \
                        and track.state != TrackState.UNCERTAIN:
                    chain = track.get_frame_pose(idx)
                    if chain is None:
                        continue
                    slot = track.reconstruction.slot
                    jj = pending_j[track.id]
                    t_px = int(extra["trunc_px"][jj])
                    if t_px > 0:
                        self.oversize_masks += 1
                    if t_px > 0 and \
                            self.config.instance_map.oversize_mask_fallback:
                        # the crop would lose t_px mask pixels: fuse the full
                        # masked frame now instead of routing the crop
                        reset = bool(self._route_reset[slot])
                        self._route_reset[slot] = False
                        print(f"[frame {frame_no}: slot {slot} mask exceeds "
                              f"the {self.crop_h}x{self.crop_w} fusion crop "
                              f"by {t_px} px -> full-frame fallback fusion]",
                              file=sys.stderr)
                        h, w = self.cfg.height, self.cfg.width
                        fuse_slot_fullframe(
                            self.icfg, self.decay_params.enabled,
                            self.carry.inst, self.carry.inst_fidx, slot,
                            outputs.depth_m, extra["rgb"],
                            self._exclusive_copy_mask(extra, jj, h, w), chain,
                            reset, self.intr_host,
                            float(self.decay_params.max_decay_weight),
                            int(self.decay_params.min_decay_age))
                    else:
                        if t_px > 0:
                            # fallback off: the volume loses these pixels this
                            # frame — counted and logged
                            self.truncated_pixels += t_px
                            print(f"[frame {frame_no}: slot {slot} mask "
                                  f"TRUNCATED by {t_px} px (fusion crop "
                                  f"{self.crop_h}x{self.crop_w}, "
                                  f"oversize_mask_fallback=False)]",
                                  file=sys.stderr)
                        self._route_src[slot] = jj
                        self._route_pose[slot] = chain.astype(np.float32)
                    track.reconstruction.fused_frames += 1
                    track.count_fused_frame()
                    track.needs_cleanup = True

            self.tracker.prune_tracks(frame_no)

        if self.evaluation is not None and (
                self._final_frame is None or frame_no <= self._final_frame):
            self._stash_eval(frame_no, dets, outputs, pose,
                             int(get("used_blocks")[0]),
                             int(get("decayed_blocks")[0]), extra)

    # ------------------------------------------------------------------
    def _stash_eval(self, frame_no, dets_full, outputs, pose_w2c,
                    used_blocks, decayed_blocks, extra) -> None:
        """Stage frame ``frame_no``'s evaluation: the association map and
        each object volume's render pose are host state as of this
        frame's tracker pass; the render waits for the dispatch that fuses
        this frame's cut views (``dispatch_lag`` dispatches later), so
        that the volumes hold what the reference renders after the frame's
        fusion (Evaluation.cpp:93-100). Writes the frame's tracker row."""
        with _dyn_stage("eval_stash"):
            h, w = self.cfg.height, self.cfg.width
            det_states = {}
            for track in self.tracker.active_tracks.values():
                for f in reversed(track.frames):
                    if f.frame_idx <= frame_no:
                        det_states[id(f.detection)] = track.state
                        break
            pd = [d for d in (dets_full or []) if d.is_possibly_dynamic()]
            if len(pd) <= self.K:
                # the step's copy-mask planes are build_association_map's
                # rasterization (bit j = detection j when no slot overflow
                # reordered them); only the (K,) codes go up
                codes = np.zeros(self.K, np.int8)
                for j, det in enumerate(pd):
                    st = det_states.get(id(det))
                    certain = st is not None and st != TrackState.UNCERTAIN
                    codes[j] = ASSOC_DYNAMIC \
                        if det.is_reconstructable() and certain \
                        else ASSOC_SKIP
                assoc = assoc_bits_to_map(extra["copy_bits"],
                                          upload(codes, self.device), self.K)
            else:
                assoc = build_association_map(
                    h, w, SimpleNamespace(instance_detections=dets_full),
                    self.tracker, det_states=det_states)
            vol_c2w = np.tile(np.eye(4, dtype=np.float32), (self.S, 1, 1))
            active = np.zeros(self.S, bool)
            # per-slot render viewport origin (u0, v0), and whether the
            # detection bbox (with a motion margin) fits the crop; the
            # other slots (and tracks without a detection at this frame)
            # render the full frame
            vol_org = np.zeros((self.S, 2), np.int32)
            vol_crop = np.zeros(self.S, bool)
            margin = min(48, self.crop_h // 4, self.crop_w // 4)
            for track in self.tracker.active_tracks.values():
                if not track.has_reconstruction() or not track.frames:
                    continue
                idxs = [i for i, f in enumerate(track.frames)
                        if f.frame_idx <= frame_no]
                if not idxs:
                    continue
                k = idxs[-1]
                chain = track.get_frame_pose(k)
                if chain is None:
                    continue
                cam_pose = track.frames[k].camera_pose
                # p_view = pose_w2c @ C2W_k @ chain_k @ p_vol (the
                # composited render poses, InstanceReconstructor.cpp:
                # 911-931)
                vol_w2c = pose_w2c @ np.linalg.inv(cam_pose) @ chain
                slot = track.reconstruction.slot
                vol_c2w[slot] = np.linalg.inv(vol_w2c).astype(np.float32)
                active[slot] = True
                if self.icfg_render is not None \
                        and track.frames[k].frame_idx == frame_no:
                    bb = track.frames[k].detection.copy_mask.bbox
                    ch, cw = self.crop_h, self.crop_w
                    u0 = min(max(int((bb.x0 + bb.x1) * 0.5) - cw // 2, 0),
                             w - cw)
                    v0 = min(max(int((bb.y0 + bb.y1) * 0.5) - ch // 2, 0),
                             h - ch)
                    if (bb.x0 - margin >= u0 and bb.x1 + margin < u0 + cw
                            and bb.y0 - margin >= v0
                            and bb.y1 + margin < v0 + ch):
                        vol_org[slot] = (u0, v0)
                        vol_crop[slot] = True
            self.evaluation.log_tracker(
                frame_no, len(self.tracker.active_tracks), int(active.sum()),
                self._dropped_detections, self.oversize_masks,
                self.truncated_pixels)
            self._eval_pending = (
                frame_no, outputs.raycast.depth, outputs.depth_m, assoc,
                vol_c2w, active, vol_org, vol_crop, used_blocks,
                decayed_blocks,
                frame_no + self.dispatch_lag,  # ready after this dispatch
            )

    def _flush_eval(self, force: bool = False) -> None:
        """Render the staged frame — the static render with every active
        object volume z-merged in: a crop-viewport render where the
        detection fits the crop, else a full-frame one, merged by one
        ``composite_depth_many`` — and submit it, once the volumes include
        the frame; ``force`` renders the volumes as they are (finalize)."""
        if self._eval_pending is None or self.evaluation is None:
            return
        (frame_no, rc_depth, depth_m, assoc, vol_c2w, active, vol_org,
         vol_crop, used_blocks, decayed_blocks, ready) = self._eval_pending
        if self.current_frame_no - 1 < ready and not force:
            return
        self._eval_pending = None
        with _dyn_stage("eval_render"):
            rendered = rc_depth
            if active.any():
                rendered = rc_depth.clone()
                for s in np.flatnonzero(active & vol_crop):
                    u0, v0 = (int(x) for x in vol_org[s])
                    crop = self.render_instance_crop(int(s), vol_c2w[s], u0,
                                                     v0)
                    merge_crop_depth(rendered, crop.depth, v0, u0)
                    self.eval_crop_renders += 1
                full = np.flatnonzero(active & ~vol_crop)
                if full.size:
                    depths = torch.stack([
                        self.raycast_instance(int(s), vol_c2w[s]).depth
                        for s in full])
                    rendered = mask_ops.composite_depth_many(rendered,
                                                             depths)
                    self.eval_full_renders += int(full.size)
            self.evaluation.submit(frame_no, rendered, depth_m, assoc,
                                   used_blocks, decayed_blocks)

    # ------------------------------------------------------------------
    def finalize(self) -> None:
        """Finish the deferred tracker pass and fuse the last pending
        crops with fusion-only replays of the last frame's images (two at
        lag 2: the pending buffer is two deep); then render the last
        staged evaluation and write every outstanding row."""
        if self.carry is None or self._dispatch_meta is None:
            return
        # frames past the last real one are fusion-only replays
        self._final_frame = self.current_frame_no - 1
        if self.dispatch_lag == 2:
            for _ in range(2):
                self.process_frame(self.carry.prev_lg, self.carry.prev_rg,
                                   None, [])
            self._finish_prev()
        else:
            self._finish_prev()
            if (self._route_src >= 0).any():
                self.process_frame(self.carry.prev_lg, self.carry.prev_rg,
                                   None, [])
                self._finish_prev()
        self._flush_eval(force=True)
        if self.evaluation is not None:
            self.evaluation.drain()

    # -- accessors ------------------------------------------------------
    def get_pose(self) -> np.ndarray:
        return self.carry.pose_w2c.cpu().numpy()

    def get_last_egomotion(self) -> np.ndarray:
        return getattr(self, "last_egomotion", np.eye(4, dtype=np.float32))

    def get_used_block_count(self) -> int:
        return int(tsdf.memory_stats(self.cfg, self.carry.state)[0])

    def get_dropped_allocation_count(self) -> int:
        return int(self.carry.dropped)

    def get_dropped_detection_count(self) -> int:
        """Possibly-dynamic detections past the K mask slots, cumulative."""
        return self._dropped_detections

    def reconstructed_objects(self) -> List[int]:
        """Track ids with a live reconstruction volume."""
        return [t.id for t in self.tracker.active_tracks.values()
                if t.has_reconstruction()]

    def composited_preview(self) -> np.ndarray:
        """Static raycast colour with per-track tinted object renders
        z-merged in (CompositeInstances, InstanceReconstructor.cpp:
        933-990)."""
        rc = self.last_outputs.raycast
        view_w2c = self.get_pose().astype(np.float64)
        renders, tints = [], []
        for t in self.tracker.active_tracks.values():
            if not t.has_reconstruction() or not t.frames:
                continue
            k = len(t.frames) - 1
            chain = t.get_frame_pose(k)
            # p_view = view_w2c @ C2W_k @ chain_k @ p_vol
            vol_w2c = view_w2c @ np.linalg.inv(t.frames[k].camera_pose) \
                @ chain
            renders.append(self.raycast_instance(t.reconstruction.slot,
                                                 np.linalg.inv(vol_w2c)))
            tints.append(PALETTE[t.id % len(PALETTE)])
        if not renders:
            return rc.color.cpu().numpy()
        out_color, _ = mask_ops.composite_color_many(
            rc.color, rc.depth, torch.stack([r.color for r in renders]),
            torch.stack([r.depth for r in renders]),
            upload(np.stack(tints), self.device))
        return out_color.cpu().numpy()

    def render_instance_crop(self, slot: int, cam_to_world, u0: int,
                             v0: int) -> Raycast:
        """Render one pooled object volume into the (crop_h, crop_w)
        viewport at (u0, v0) of the frame: K2 on the crop configuration
        with the principal point shifted by the crop origin. The render's
        cost follows the object's screen area, not the frame's."""
        icfg = self.icfg_render
        fx, fy, cx, cy = (float(x) for x in self.intr_host)
        small = upload(np.concatenate([
            np.asarray(cam_to_world, np.float32).reshape(16),
            np.asarray([fx, fy, cx - u0, cy - v0], np.float32)]),
            self.device)
        c2w, intr4 = small[:16].reshape(4, 4), small[16:]
        state = tsdf.pool_slot(self.carry.inst, slot)
        origin = tsdf.compute_origin(icfg, c2w)
        grid = tsdf.build_local_grid(icfg, state, origin)
        slots, mask = tsdf.visible_blocks(icfg, state, grid, origin,
                                          se3.inverse(c2w), intr4=intr4)
        return raycast(icfg, state, grid, origin, slots, mask, c2w, intr4)

    def raycast_instance(self, slot: int, cam_to_world) -> Raycast:
        """Render one pooled object volume at the full frame (K2 on the
        instance configuration)."""
        state = tsdf.pool_slot(self.carry.inst, slot)
        c2w = upload(np.asarray(cam_to_world, np.float32), self.device)
        origin = tsdf.compute_origin(self.icfg, c2w)
        grid = tsdf.build_local_grid(self.icfg, state, origin)
        slots, mask = tsdf.visible_blocks(self.icfg, state, grid, origin,
                                          se3.inverse(c2w))
        return raycast(self.icfg, state, grid, origin, slots, mask, c2w,
                       self.intr_vec)
