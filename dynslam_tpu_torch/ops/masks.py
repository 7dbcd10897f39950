"""Compositing of object renders into the static render — the port of
``composite_depth`` and ``composite_color`` of ``dynslam_tpu/ops/masks.py``
(CompositeDepth / CompositeColor, InstanceReconstructor.cpp:851-911)."""

from __future__ import annotations

import torch


def composite_depth(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Z-merge two depth maps, 0 = empty."""
    both = (target > 0) & (source > 0)
    return torch.where(both, torch.minimum(target, source),
                       torch.where(target > 0, target, source))


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
