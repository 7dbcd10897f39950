"""TSDF fusion of one view in plain PyTorch: a frozen copy of the port's
``integrate_ref`` (the rule its CUDA kernel ``csrc/integrate.cu`` is held
to bit for bit), with ``integrate`` and ``integrate_many`` taking it
volume by volume on any device."""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference._util import constant
from benchmark.reference.tsdf import (
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


def integrate(cfg, state, slots, slots_mask, rgb, depth_m, world_to_cam,
              frame_idx, intr4=None) -> TsdfState:
    """Fuse one view into the visible blocks, in place."""
    return integrate_ref(cfg, state, slots, slots_mask, rgb, depth_m,
                         world_to_cam, frame_idx, intr4)


def integrate_many(cfg, pool, vols, slots, slots_mask, rgb, depth_m,
                   world_to_cam, frame_idx, intr4) -> TsdfState:
    """Fuse one view into each of n volumes of a stacked pool, in place."""
    if len(set(vols)) != len(vols):
        raise ValueError("integrate_many: volumes must be distinct")
    for i, s in enumerate(vols):
        integrate_ref(cfg, pool_slot(pool, s), slots[i], slots_mask[i],
                      rgb[i], depth_m[i], world_to_cam[i], frame_idx[i],
                      intr4[i])
    return pool
