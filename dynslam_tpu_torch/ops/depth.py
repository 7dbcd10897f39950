"""Depth-map conversions — the port of ``dynslam_tpu/ops/depth.py``.

- ``depth_mm_from_disparity``: ``DepthProvider::DepthFromDisparityMap``
  semantics (DepthProvider.h:94-137): disparity -> int16 mm depth with
  range clamping, 0 = invalid.
- ``depth_m_from_mm``: int16 mm -> float32 m.
- ``disparity_from_depth_m``: float depth -> disparity, 0 where invalid.
- ``bilateral_filter_depth``: InfiniTAM's 5-pass bilateral filter of the
  input depth (``UpdateView`` with ``useBilateralFilter``).
- ``rgb_to_gray``: OpenCV weights, as the reference converts before viso2.
"""

from __future__ import annotations

import math

import torch

from dynslam_tpu_torch.ops.tsdf import recip32

MM_PER_M = 1000.0
#: metres a mm: the float32 reciprocal of 1000, as XLA evaluates the JAX
#: package's division inside its jitted frame step
M_PER_MM = recip32(MM_PER_M)


def mm_range(min_depth_m: float, max_depth_m: float):
    """The valid depth range (min, max) in whole mm."""
    return int(min_depth_m * MM_PER_M), int(max_depth_m * MM_PER_M)


def depth_mm_from_disparity(
    disparity_px: torch.Tensor,
    bf: float,
    min_depth_m: float = 0.5,
    max_depth_m: float = 20.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Disparity (H, W) float -> int16 depth in mm; |disp| < 1e-5 and
    out-of-range depths become 0."""
    min_mm, max_mm = mm_range(min_depth_m, max_depth_m)
    den = torch.where(
        disparity_px.abs() < 1e-5,
        torch.full_like(disparity_px, float("inf")),
        disparity_px,
    )
    depth_m = bf / den
    depth_mm = MM_PER_M * scale * depth_m
    # the reference casts through int32 before the range check; the
    # upper clamp is the largest float32 below 2**31
    depth_mm_i = torch.where(
        torch.isfinite(depth_mm),
        torch.clamp(depth_mm, -(2.0 ** 31), 2.0 ** 31 - 128).to(torch.int32),
        torch.zeros_like(depth_mm, dtype=torch.int32),
    )
    invalid = (depth_mm_i > max_mm) | (depth_mm_i < min_mm)
    return torch.where(invalid, 0, depth_mm_i).to(torch.int16)


def depth_m_from_mm(depth_mm: torch.Tensor) -> torch.Tensor:
    """int16 mm depth -> float32 meters, 0 stays 0 (invalid): a product
    with ``M_PER_MM``."""
    return depth_mm.to(torch.float32) * M_PER_MM


def disparity_from_depth_m(depth_m: torch.Tensor, bf: float) -> torch.Tensor:
    """float depth (m) -> disparity (px); invalid (<= 0) depth -> 0."""
    return torch.where(depth_m > 1e-6,
                       bf / torch.clamp(depth_m, min=1e-6), 0.0)


def bilateral_filter_depth(depth_m: torch.Tensor, radius: int = 2,
                           sigma_space: float = 1.5,
                           sigma_depth: float = 0.03,
                           steps: int = 5) -> torch.Tensor:
    """Edge-preserving smoothing of a float depth map in ``steps``
    passes of a (2 radius + 1)^2 stencil; invalid (0) pixels neither
    contribute nor get filled, and the stencil wraps at the borders as
    the JAX package's ``jnp.roll`` form does."""
    offsets = [(dy, dx) for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1)]
    spatial_w = [math.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space ** 2))
                 for dy, dx in offsets]
    inv2s2 = recip32(2.0 * sigma_depth ** 2)
    d = depth_m
    for _ in range(steps):
        valid = d > 0
        acc = torch.zeros_like(d)
        wacc = torch.zeros_like(d)
        for (dy, dx), sw in zip(offsets, spatial_w):
            shifted = torch.roll(d, (dy, dx), (0, 1))
            sh_valid = torch.roll(valid, (dy, dx), (0, 1))
            w = sw * torch.exp(-torch.square(shifted - d) * inv2s2)
            w = torch.where(sh_valid & valid, w, 0.0)
            acc = acc + w * shifted
            wacc = wacc + w
        out = torch.where(wacc > 1e-8, acc / torch.clamp(wacc, min=1e-8), d)
        d = torch.where(valid, out, 0.0)
    return d


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (H, W, 3) -> uint8 grayscale, OpenCV weights."""
    f = rgb.to(torch.float32)
    gray = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    return torch.clamp(gray + 0.5, 0, 255).to(torch.uint8)
