"""Silhouette cuts and the compositing of object renders into the static
render — the port of ``dynslam_tpu/ops/masks.py``: ``cut_out_instance``
and ``remove_silhouette`` (ProcessSilhouette_CPU / RemoveSilhouette_CPU,
InstanceReconstructor.cpp:59-170, on device views), ``composite_depth``,
``composite_depth_many``, ``composite_color`` and ``composite_color_many``
(CompositeDepth / CompositeColor, :851-911). Depths are >= 0, 0 = empty,
as renders give them."""

from __future__ import annotations

from typing import Optional

import torch


def cut_out_instance(rgb: torch.Tensor, depth_m: torch.Tensor,
                     copy_mask: torch.Tensor, delete_mask: torch.Tensor):
    """ProcessSilhouette + RemoveSilhouette in one: the object's view (the
    copy mask's pixels) and the main view without the delete mask's.
    Returns (inst_rgb, inst_depth, main_rgb, main_depth)."""
    inst_rgb = torch.where(copy_mask[..., None], rgb, 0).to(rgb.dtype)
    inst_depth = torch.where(copy_mask, depth_m, 0.0)
    main_rgb, main_depth = remove_silhouette(rgb, depth_m, delete_mask)
    return inst_rgb, inst_depth, main_rgb, main_depth


def remove_silhouette(rgb: torch.Tensor, depth_m: torch.Tensor,
                      delete_mask: torch.Tensor):
    """Zero the masked pixels of the main view: (rgb, depth)."""
    return (torch.where(delete_mask[..., None], 0, rgb).to(rgb.dtype),
            torch.where(delete_mask, 0.0, depth_m))


def composite_depth(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Z-merge two depth maps, 0 = empty."""
    both = (target > 0) & (source > 0)
    return torch.where(both, torch.minimum(target, source),
                       torch.where(target > 0, target, source))


def composite_depth_many(
    target: torch.Tensor,  # (H, W) f32
    inst_depths: torch.Tensor,  # (S, H, W) f32, 0 = empty
    active: Optional[torch.Tensor] = None,  # (S,) bool; None: every slot
) -> torch.Tensor:
    """Every active layer z-merged into ``target`` in one pass: the
    nearest positive depth, else 0 — equal to ``composite_depth`` applied
    slot by slot."""
    if active is not None:
        inst_depths = torch.where(active[:, None, None], inst_depths, 0.0)
    layers = torch.cat([target[None], inst_depths])
    near = torch.where(layers > 0, layers, torch.inf).amin(0)
    return torch.where(torch.isinf(near), 0.0, near)


def composite_color(
    target_color: torch.Tensor,  # (H, W, 3) uint8
    target_depth: torch.Tensor,  # (H, W) f32
    inst_color: torch.Tensor,  # (H, W, 3) uint8
    inst_depth: torch.Tensor,  # (H, W) f32
    tint: torch.Tensor,  # (3,) f32 0..255
    tint_strength: float = 0.6,
):
    """Software z-buffer colour merge with a per-track tint. Returns
    (color, depth)."""
    on_top = (inst_depth > 0) & ((target_depth == 0)
                                 | (target_depth > inst_depth))
    strength = 1.0 + 0.5 - tint_strength
    tinted = torch.clamp(inst_color.to(torch.float32) * strength
                         + tint[None, None, :] * tint_strength,
                         0, 255).to(torch.uint8)
    out_color = torch.where(on_top[..., None], tinted, target_color)
    out_depth = torch.where(on_top, inst_depth, target_depth)
    return out_color, out_depth


def composite_color_many(
    target_color: torch.Tensor,  # (H, W, 3) uint8
    target_depth: torch.Tensor,  # (H, W) f32
    inst_colors: torch.Tensor,  # (S, H, W, 3) uint8
    inst_depths: torch.Tensor,  # (S, H, W) f32
    tints: torch.Tensor,  # (S, 3) f32
    active: Optional[torch.Tensor] = None,  # (S,) bool; None: every slot
    tint_strength: float = 0.6,
):
    """``composite_color`` over the slot axis in one pass: a pixel takes
    the tinted colour of the first slot at the nearest positive depth when
    that depth is strictly nearer than the target's (or the target is
    empty) — the slot-by-slot merge, whose strict z-test lets earlier
    slots win ties. Returns (color, depth)."""
    live = inst_depths > 0
    if active is not None:
        live &= active[:, None, None]
    d = torch.where(live, inst_depths, torch.inf)
    near, win = d.min(0)  # min returns the first slot at the minimum
    on_top = torch.isfinite(near) & ((target_depth == 0)
                                     | (target_depth > near))
    strength = 1.0 + 0.5 - tint_strength
    tinted = torch.clamp(inst_colors.to(torch.float32) * strength
                         + tints[:, None, None, :] * tint_strength,
                         0, 255).to(torch.uint8)
    pick = torch.gather(tinted, 0, win[None, ..., None].expand(
        1, *win.shape, 3))[0]
    out_color = torch.where(on_top[..., None], pick, target_color)
    out_depth = torch.where(on_top, near, target_depth)
    return out_color, out_depth
