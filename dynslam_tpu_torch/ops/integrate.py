"""TSDF fusion of one view: the CUDA kernel ``csrc/integrate.cu`` and its
plain PyTorch version ``integrate_ref``.

Replaces ``dynslam_tpu/ops/pallas_integrate.py::integrate_pallas``. The
rule is ``dynslam_tpu/ops/tsdf.py::integrate`` (the oracle, not the
Pallas kernel, which diverges when its near tier overflows).

``integrate`` fuses one view into one map; ``integrate_many`` fuses one
view into each of n volumes of a stacked pool in one launch (the volume
axis, the counterpart of the JAX package's vmap over pooled object
volumes). Both dispatch on the device of the pool: CPU tensors take
``integrate_ref`` (volume by volume); CUDA tensors launch the kernel, and a
failed build or launch raises. Both update the pool IN PLACE (this
replaces the JAX package's ``donate_argnames``) and return it.
``integrate.launches`` counts the kernel launches of both.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Optional, Sequence

import numpy as np
import torch

from dynslam_tpu_torch.device import constant, upload
from dynslam_tpu_torch.ops import cuda_build
from dynslam_tpu_torch.ops.tsdf import (
    BLOCK, BLOCK3, SDF_SCALE, TsdfConfig, TsdfState, fma, frame_tensor,
    pack_rgb, pack_voxel, pool_slot, recip32, transform_points,
    unpack_weight,
)

#: (512, 3) voxel offsets within a block, idx = (x * 8 + y) * 8 + z
_VOX_IDX = torch.arange(BLOCK3)
_VOX_OFFSETS = torch.stack([_VOX_IDX // 64, (_VOX_IDX // 8) % 8, _VOX_IDX % 8], -1)


def _intr4(cfg: TsdfConfig, intr4: Optional[torch.Tensor], device) -> torch.Tensor:
    if intr4 is None:
        return constant((cfg.fx, cfg.fy, cfg.cx, cfg.cy), torch.float32,
                        device)
    return intr4.to(device=device, dtype=torch.float32)


def integrate_ref(
    cfg: TsdfConfig,
    state: TsdfState,
    slots: torch.Tensor,  # (V,) int pool slots
    slots_mask: torch.Tensor,  # (V,) bool
    rgb: torch.Tensor,  # (H, W, 3) uint8
    depth_m: torch.Tensor,  # (H, W) f32, 0 = invalid
    world_to_cam: torch.Tensor,  # (4, 4) f32
    frame_idx,  # int or 0-d int32 tensor
    intr4: Optional[torch.Tensor] = None,  # (4,) fx fy cx cy
) -> TsdfState:
    """The plain rule of ``tsdf.integrate``, vectorised over (V, 512)
    voxels; updates ``state`` in place.

    The arithmetic is the JAX rule as XLA's CPU backend evaluates it (the
    parity tests' reference): divisions by a constant are multiplications
    by its float32 reciprocal, and ``a * b + c`` is one fused
    multiply-add. The CUDA kernel writes the same operations out."""
    dev = state.device
    intr = _intr4(cfg, intr4, dev)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    # only the unmasked entries are fused; masked ones leave the pool as
    # it is, so they are dropped up front (one host sync)
    slots_c = slots[slots_mask].to(torch.int64)

    coords = state.block_coords[slots_c].to(torch.float32)  # (V, 3)
    vox = _VOX_OFFSETS.to(device=dev, dtype=torch.float32)
    pw = (coords[:, None, :] * BLOCK + vox[None, :, :] + 0.5) * cfg.voxel_size
    pc = transform_points(world_to_cam, pw)
    z = pc[..., 2]
    safe_z = torch.clamp(z, min=1e-3)
    u = fma(pc[..., 0] / safe_z, fx, cx)
    v = fma(pc[..., 1] / safe_z, fy, cy)

    img_h, img_w = depth_m.shape
    ui = torch.clamp(torch.round(u).to(torch.int32), 0, img_w - 1)
    vi = torch.clamp(torch.round(v).to(torch.int32), 0, img_h - 1)
    in_img = (u >= 0) & (u <= img_w - 1) & (v >= 0) & (v <= img_h - 1) \
        & (z > 1e-3)
    px = (vi * img_w + ui).to(torch.int64)
    depth_mm_i = torch.clamp(depth_m * 1000.0, 0, 65535).to(torch.int32)
    d = depth_mm_i.reshape(-1)[px].to(torch.float32) * recip32(1000.0)
    d_ok = (d >= cfg.min_depth) & (d <= cfg.max_depth)

    eta = d - z
    update = in_img & d_ok & (eta > -cfg.mu)
    sdf_obs = torch.clamp(eta * recip32(cfg.mu), -1.0, 1.0)
    if cfg.use_depth_weighting:
        # a true division, as XLA's and the kernel's: a Python scalar over
        # a tensor is its reciprocal times the scalar (``__rtruediv__``)
        q = torch.div(d.new_tensor(cfg.max_depth), torch.clamp(d, min=0.5))
        w_obs = torch.clamp(q * q, 0.25, 5.0)
    else:
        w_obs = torch.ones_like(d)
    w_obs = torch.where(update, w_obs, 0.0)

    packed_old = state.tsdf_w[slots_c]
    w_old = unpack_weight(packed_old)
    t_old = (packed_old >> 16).to(torch.float32) * recip32(SDF_SCALE)
    w_new = torch.clamp(w_old + w_obs, max=cfg.max_weight)
    den = torch.clamp(w_old + w_obs, min=1e-6)
    t_new = torch.where(w_obs > 0, fma(t_old, w_old, sdf_obs * w_obs) / den,
                        t_old)
    packed_new = pack_voxel(t_new, w_new)

    c_bits = state.color[slots_c]
    c_old = torch.stack(
        [(c_bits >> 16) & 0xFF, (c_bits >> 8) & 0xFF, c_bits & 0xFF], -1
    ).to(torch.float32)
    rgb_px = rgb.reshape(-1, 3)[px].to(torch.float32)  # (V, 512, 3)
    c_upd = (update & (eta.abs() < cfg.mu * 0.25))[..., None]
    c_new = torch.where(
        c_upd,
        fma(c_old, w_old[..., None], rgb_px * w_obs[..., None])
        / den[..., None],
        c_old,
    )

    state.tsdf_w[slots_c] = packed_new
    state.color[slots_c] = pack_rgb(c_new)
    state.last_seen[slots_c] = frame_tensor(frame_idx, (), dev)
    return state


def _check_pool(cfg: TsdfConfig, pool: TsdfState) -> None:
    P = cfg.pool_capacity
    for name, shape in (("tsdf_w", (P, BLOCK3)), ("color", (P, BLOCK3)),
                        ("block_coords", (P, 3)), ("last_seen", (P,))):
        t = getattr(pool, name)
        if t.shape[1:] != shape or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"integrate: {name} must be contiguous int32 "
                             f"(S, *{shape})")
    # pool rows move as 16-byte vectors
    if pool.tsdf_w.data_ptr() % 16 or pool.color.data_ptr() % 16:
        raise ValueError("integrate: tsdf_w and color must be 16-byte "
                         "aligned")


def _launch_args(cfg, pool, vols, slots, slots_mask, rgb, depth_m,
                 world_to_cam, intr, frame, frame_scalar: int = 0
                 ) -> cuda_build.Launch:
    """The kernel's C call over n volumes of the stacked ``pool``, ready to
    run: ``vols`` (n,) int32 pool slots on the device, then per volume its
    visible list (n, V), view (n, H, W[, 3]), pose (n, 4, 4), intrinsics
    (n, 4) and frame index (n,) (None: every volume at ``frame_scalar``).
    Tensors of the kernel's types pass as they are: no conversion
    launches."""
    dev = pool.device
    _check_pool(cfg, pool)
    n = slots.shape[0]
    named = (("slots", slots), ("slots_mask", slots_mask), ("rgb", rgb),
             ("depth_m", depth_m), ("world_to_cam", world_to_cam),
             ("intr4", intr), ("vols", vols), ("frame_idx", frame))
    for name, t in named:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"integrate: {name} on {t.device}, pool on {dev}")
        if t.shape[0] != n:
            raise ValueError(f"integrate: {name} must have {n} volumes")
    img_h, img_w = depth_m.shape[1:]
    if rgb.shape != (n, img_h, img_w, 3) or rgb.dtype != torch.uint8:
        raise ValueError(f"integrate: rgb must be uint8 {(n, img_h, img_w, 3)}")
    if slots.dim() != 2 or slots_mask.shape != slots.shape \
            or slots_mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError("integrate: slots and a bool slots_mask must be "
                         "(n, V)")
    if world_to_cam.shape != (n, 4, 4) or intr.shape != (n, 4):
        raise ValueError("integrate: world_to_cam must be (n, 4, 4), intr4 "
                         "(n, 4)")
    slots_i = slots.to(torch.int32).contiguous()
    mask_c = slots_mask.contiguous()  # bool is one byte 0/1, as uint8
    depth_f = depth_m.to(torch.float32).contiguous()
    rgb_c = rgb.contiguous()
    w2c = world_to_cam.to(torch.float32).contiguous()
    intr_c = intr.to(torch.float32).contiguous()
    vols_i = vols.to(torch.int32).contiguous()
    frame_i = None if frame is None else frame.to(torch.int32).contiguous()
    fn = cuda_build.function("integrate", "dynslam_integrate",
                             "pppp i pi ppi ppppp i ii fffffffff i p")
    args = (
        pool.tsdf_w.data_ptr(), pool.color.data_ptr(),
        pool.block_coords.data_ptr(), pool.last_seen.data_ptr(),
        cfg.pool_capacity, vols_i.data_ptr(), n,
        slots_i.data_ptr(), mask_c.data_ptr(), slots_i.shape[1],
        depth_f.data_ptr(), rgb_c.data_ptr(), w2c.data_ptr(),
        intr_c.data_ptr(), None if frame_i is None else frame_i.data_ptr(),
        int(frame_scalar), img_h, img_w,
        cfg.voxel_size, cfg.mu, recip32(cfg.mu), cfg.mu * 0.25,
        recip32(1000.0), recip32(SDF_SCALE), cfg.max_weight, cfg.min_depth,
        cfg.max_depth, int(cfg.use_depth_weighting),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return cuda_build.Launch(fn, args, (slots_i, mask_c, depth_f, rgb_c, w2c,
                                        intr_c, vols_i, frame_i))


def _launch(*args, **kw) -> None:
    """Build the C call with ``_launch_args`` and run it once."""
    cuda_build.check_launch(_launch_args(*args, **kw)(), "integrate")
    integrate.launches += 1


def _as_pool(state: TsdfState) -> TsdfState:
    """One map as a pool of one: views with a leading axis of 1."""
    return TsdfState(*(getattr(state, f.name)[None] for f in fields(state)))


def single_view_args(cfg: TsdfConfig, state: TsdfState, slots, slots_mask,
                     rgb, depth_m, world_to_cam, frame_idx, intr4=None):
    """``integrate``'s arguments as ``_launch_args`` takes them: the map
    as pool slot 0 (a cached device constant), a volume axis of 1, the
    frame index as a scalar when it is an int."""
    dev = state.device
    scalar = not torch.is_tensor(frame_idx)
    return ((cfg, _as_pool(state), constant((0,), torch.int32, dev),
             slots[None], slots_mask[None],
             rgb[None], depth_m[None], world_to_cam[None],
             _intr4(cfg, intr4, dev)[None],
             None if scalar else frame_tensor(frame_idx, (1,), dev)),
            dict(frame_scalar=int(frame_idx) if scalar else 0))


def integrate(
    cfg: TsdfConfig,
    state: TsdfState,
    slots: torch.Tensor,
    slots_mask: torch.Tensor,
    rgb: torch.Tensor,
    depth_m: torch.Tensor,
    world_to_cam: torch.Tensor,
    frame_idx,
    intr4: Optional[torch.Tensor] = None,
) -> TsdfState:
    """Fuse one view into the visible blocks, in place. CPU pool: the
    plain version; CUDA pool: the kernel at one volume
    (``integrate.launches`` counts its launches)."""
    dev = state.device
    if dev.type == "cpu":
        return integrate_ref(cfg, state, slots, slots_mask, rgb, depth_m,
                             world_to_cam, frame_idx, intr4)
    if dev.type == "cuda":
        args, kw = single_view_args(cfg, state, slots, slots_mask, rgb,
                                    depth_m, world_to_cam, frame_idx, intr4)
        _launch(*args, **kw)
        return state
    raise ValueError(f"integrate: unsupported device {dev}")


def integrate_many(
    cfg: TsdfConfig,
    pool: TsdfState,  # stacked (S, P, ...) maps
    vols: Sequence[int],  # (n,) pool slots to fuse, distinct
    slots: torch.Tensor,  # (n, V) visible blocks of each
    slots_mask: torch.Tensor,  # (n, V)
    rgb: torch.Tensor,  # (n, H, W, 3) uint8
    depth_m: torch.Tensor,  # (n, H, W) f32
    world_to_cam: torch.Tensor,  # (n, 4, 4)
    frame_idx: Sequence[int],  # (n,)
    intr4: torch.Tensor,  # (n, 4)
) -> TsdfState:
    """Fuse one view into each of n volumes of a stacked pool, in place —
    the volume axis of the kernel, one launch for all n. CPU pool: the
    plain version, volume by volume."""
    dev = pool.device
    if len(set(vols)) != len(vols):
        raise ValueError("integrate_many: volumes must be distinct")
    n_pool = pool.tsdf_w.shape[0]
    if any(not 0 <= s < n_pool for s in vols):
        raise ValueError(f"integrate_many: volumes {list(vols)} outside the "
                         f"pool of {n_pool}")
    if dev.type == "cpu":
        for i, s in enumerate(vols):
            integrate_ref(cfg, pool_slot(pool, s), slots[i], slots_mask[i],
                          rgb[i], depth_m[i], world_to_cam[i], frame_idx[i],
                          intr4[i])
        return pool
    if dev.type == "cuda":
        if len(vols):
            _launch(cfg, pool, upload(np.asarray(vols, np.int32), dev), slots,
                    slots_mask, rgb, depth_m, world_to_cam, intr4,
                    upload(np.asarray(frame_idx, np.int32), dev))
        return pool
    raise ValueError(f"integrate_many: unsupported device {dev}")


integrate.launches = 0
