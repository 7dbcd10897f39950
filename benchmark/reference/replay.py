"""The reference's side of the correctness check: it works out a captured
frame step again from the inputs the benchmark made.

The port's map, features and host tracker are state that only the whole
drive before a frame builds, and the plain march takes seconds a frame,
so the reference follows the port step by step: it takes the state the
port handed to a step (its carry, its generator's position and, in the
dynamic step, the host tracker's routing), and recomputes that step from
the frame's own images, with its own configuration, its own mask planes
from the dump files and its own plain kernels. The start is checked on
its own: frame 1 from a carry the reference builds from frame 0's images.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from benchmark.configio import build
from benchmark.reference import config as rconfig
from benchmark.reference import features as feat_ops
from benchmark.reference import step
from benchmark.reference import tsdf


class Setup(NamedTuple):
    """What the reference derives from a configuration file."""

    config: rconfig.DynSlamConfig
    cfg: tsdf.TsdfConfig  # the static map
    icfg: tsdf.TsdfConfig  # an object volume at the full frame
    icfg_fuse: tsdf.TsdfConfig  # an object volume at the fusion crop
    obj_params: rconfig.VisualOdometryParams
    K: int  # mask slots
    S: int  # object volumes


def setup(config_values: dict) -> Setup:
    """The step's configurations from a configuration file's ``config``
    object (the port's ``engine_config_from``, ``instance_config_from``
    and ``build_fused_dynamic`` rules, written again)."""
    c = build(rconfig.DynSlamConfig, config_values)
    cfg = tsdf.TsdfConfig(
        pool_capacity=c.map.pool_capacity, local_dims=c.map.local_dims,
        max_new_blocks=c.map.max_new_blocks_per_frame,
        max_visible_blocks=min(c.map.pool_capacity,
                               c.map.max_visible_blocks),
        voxel_size=c.scene.voxel_size_m, mu=c.scene.mu_m,
        max_weight=float(c.scene.max_weight), min_depth=c.min_depth_m,
        max_depth=c.max_depth_m, use_depth_weighting=c.map.use_depth_weighting,
        raycast_coarse_steps=c.map.raycast_coarse_steps,
        raycast_fine_steps=c.map.raycast_fine_steps, width=c.frame_width,
        height=c.frame_height, fx=c.intrinsics.fx, fy=c.intrinsics.fy,
        cx=c.intrinsics.cx, cy=c.intrinsics.cy)
    imp = c.instance_map
    icfg = dataclasses.replace(
        cfg, pool_capacity=imp.blocks_per_object, local_dims=imp.local_dims,
        max_new_blocks=imp.max_new_blocks_per_frame,
        max_visible_blocks=min(imp.blocks_per_object,
                               imp.max_new_blocks_per_frame * 2),
        voxel_size=imp.voxel_size_m, mu=imp.mu_m,
        max_weight=float(imp.max_weight),
        raycast_coarse_steps=imp.raycast_coarse_steps,
        raycast_fine_steps=imp.raycast_fine_steps)
    icfg_fuse = dataclasses.replace(
        icfg, width=min(imp.fusion_crop[1], c.frame_width),
        height=min(imp.fusion_crop[0], c.frame_height))
    obj = dataclasses.replace(
        c.vo, ransac_iters=c.tracker.object_ransac_iters,
        irls_rounds=c.tracker.object_irls_rounds,
        gn_iters=c.tracker.object_gn_iters)
    K = min(max(imp.max_detections, imp.max_objects), 32)
    return Setup(c, cfg, icfg, icfg_fuse, obj, K, imp.max_objects)


def decay_on(su: Setup, frame_idx: int) -> bool:
    """Whether the static map decays in the step of carry ``frame_idx``:
    from the frame whose count of frames seen (frame 0 included) reaches
    the decay age in the static pipeline, from frame number ``age`` in
    the dynamic one."""
    d = su.config.decay
    seen = frame_idx if su.config.dynamic_mode else frame_idx + 1
    return bool(d.enabled and seen >= int(d.min_decay_age))


def gray(frame_u8: np.ndarray, device) -> torch.Tensor:
    """A camera's uint8 gray frame as the step's float32 image."""
    return torch.from_numpy(np.ascontiguousarray(frame_u8)).to(
        device=device, dtype=torch.float32)


def rgb_of(lg: torch.Tensor) -> torch.Tensor:
    """The colour a gray camera gives: the gray level in all 3 channels."""
    return torch.clamp(lg, 0, 255).to(torch.uint8)[..., None].expand(
        *lg.shape, 3).contiguous()


def _features(d) -> feat_ops.Features:
    return feat_ops.Features(**d)


def _state(d) -> tsdf.TsdfState:
    return tsdf.TsdfState(**d)


def carry_from(snap: dict, dynamic: bool):
    """The reference's carry from a captured one (plain dicts)."""
    kw = dict(snap)
    kw["state"] = _state(kw["state"])
    kw["prev_l"] = _features(kw["prev_l"])
    kw["prev_r"] = _features(kw["prev_r"])
    if dynamic:
        kw["inst"] = _state(kw["inst"])
        return step.FusedDynCarry(**kw)
    return step.FusedCarry(**kw)


def fresh_carry(su: Setup, lg: torch.Tensor, rg: torch.Tensor):
    """The carry of frame 1, from frame 0's images (the pipelines'
    ``_fresh_carry``)."""
    dev = lg.device
    prev_l, prev_r = feat_ops.detect_features_pair(lg, rg, su.config.vo)
    base = dict(
        state=tsdf.create_state(su.cfg, dev),
        pose_w2c=torch.eye(4, device=dev),
        held_motion=torch.eye(4, device=dev),
        prev_l=prev_l, prev_r=prev_r, prev_lg=lg, prev_rg=rg, frame_idx=1,
        dropped=torch.zeros((), dtype=torch.int32, device=dev),
        origin=torch.full((3,), 1 << 20, dtype=torch.int32, device=dev),
        grid=torch.full((su.cfg.n_cells,), -1, dtype=torch.int32,
                        device=dev),
        prev_rc_points=torch.zeros(*lg.shape, 3, device=dev),
        prev_rc_hit=torch.zeros(lg.shape, dtype=torch.bool, device=dev))
    if not su.config.dynamic_mode:
        return step.FusedCarry(**base)
    K, ch, cw = su.K, su.icfg_fuse.height, su.icfg_fuse.width

    def crops():
        return (torch.zeros(K, ch, cw, device=dev),
                torch.zeros(K, ch, cw, 3, dtype=torch.uint8, device=dev),
                np.zeros((K, 2), np.int32))
    pd, pr, po = crops()
    qd, qr, qo = crops()
    return step.FusedDynCarry(
        **base, inst=tsdf.create_pool(su.icfg, su.S, dev),
        inst_fidx=np.zeros(su.S, np.int32), pending_depth=pd,
        pending_rgb=pr, pending_org=po, prev_pending_depth=qd,
        prev_pending_rgb=qr, prev_pending_org=qo)


def generator(device, state=None, seed=None) -> torch.Generator:
    g = torch.Generator(device=device)
    if state is not None:
        g.set_state(state)
    else:
        g.manual_seed(seed)
    return g


def run_step(su: Setup, carry, left_u8, right_u8, gen: torch.Generator,
             planes=None, routing=None, lowp: bool = False):
    """One step of the reference from ``carry`` on the frame's images:
    (carry', outputs). ``planes`` are the reference's (delete, copy)
    int64 bit-planes and ``routing`` the captured routing (dynamic)."""
    c = su.config
    dev = carry.pose_w2c.device
    lg, rg = gray(left_u8, dev), gray(right_u8, dev)
    rgb = rgb_of(lg)
    intr = [su.cfg.fx, su.cfg.fy, su.cfg.cx, su.cfg.cy]
    calib_vec = torch.tensor([su.cfg.fx, su.cfg.cx, su.cfg.cy,
                              c.calibration.baseline_m], device=dev)
    intr_vec = torch.tensor(intr, device=dev)
    bf = c.calibration.baseline_m * c.calibration.focal_length_px
    decay = decay_on(su, carry.frame_idx)
    if not c.dynamic_mode:
        return step.fused_step(
            su.cfg, c.stereo, c.vo, decay, carry, lg, rg, rgb, calib_vec,
            intr_vec, bf, float(c.decay.max_decay_weight),
            int(c.decay.min_decay_age), generator=gen, lowp=lowp)
    r = step.Routing(**{**routing,
                        "max_decay_weight": float(c.decay.max_decay_weight),
                        "min_decay_age": int(c.decay.min_decay_age)})
    db, cb = (torch.from_numpy(p.astype(np.int32)).to(dev) for p in planes)
    return step.fused_dynamic_step(
        su.cfg, su.icfg_fuse, c.stereo, c.vo, su.obj_params, decay,
        bool(c.decay.enabled), su.K, su.S, carry, lg, rg, rgb, db, cb, r,
        calib_vec, intr_vec, np.asarray(intr, np.float32), bf,
        generator=gen, fuse_from_prev=True, lowp=lowp)
