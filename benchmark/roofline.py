"""Peaks of the card and the bound of the port's fusion kernel (K1): a
copy of ``chip_smoke.py``'s ``bound``, ``k1_pixels`` and
``integrate_bound``.

The bound counts the distinct bytes K1 has to move and the operations it
has to do for one launch; the least time the card could take is the
larger of the bytes over the HBM bandwidth and the operations over the
float32 peak (NVIDIA's H100 SXM data sheet, at its 700 W limit).
"""

from __future__ import annotations

import torch

#: H100 SXM: HBM3 bandwidth (bytes/s) and float32 rate outside the tensor
#: cores (operations/s)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: float32 operations a fused voxel costs (projection, the update and the
#: colour blend)
OPS_PER_VOXEL = 64
BLOCK = 8


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least time (ms) the card could take for ``n_bytes`` moved and
    ``n_ops`` operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as the kernel's fused
    multiply-add."""
    def f64(x):
        return x.double() if torch.is_tensor(x) else x
    return (f64(a) * f64(b) + f64(c)).float()


def _transform(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p @ M[:3, :3].T + M[:3, 3]`` as the kernel evaluates it."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([_fma(M[i, 2], z, _fma(M[i, 1], y, M[i, 0] * x))
                        + M[i, 3] for i in range(3)], -1)


def k1_pixels(coords: torch.Tensor, w2c: torch.Tensor, intr, voxel_size,
              h: int, w: int) -> int:
    """The distinct pixels K1 reads in one view: the nearest pixel
    (clamped to the image) of every voxel centre of the live visible
    blocks at world block coordinates ``coords`` (V, 3)."""
    idx = torch.arange(BLOCK ** 3, device=coords.device)
    vox = torch.stack([idx // 64, (idx // 8) % 8, idx % 8], -1).float()
    pw = (coords.float()[:, None, :] * BLOCK + vox[None] + 0.5) * voxel_size
    pc = _transform(w2c.float(), pw)
    z = torch.clamp(pc[..., 2], min=1e-3)
    fx, fy, cx, cy = torch.as_tensor(intr, dtype=torch.float32,
                                     device=coords.device)
    u = torch.round(_fma(pc[..., 0] / z, fx, cx)).to(torch.int64)
    v = torch.round(_fma(pc[..., 1] / z, fy, cy)).to(torch.int64)
    px = torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)
    return int(torch.unique(px).numel())


def integrate_bound_ms(blocks: int, pixels: int, n_visible: int) -> float:
    """K1 over one volume with ``blocks`` live visible blocks and
    ``pixels`` distinct pixels read: every live block's pool rows read
    and written once (tsdf_w and colour, 4 x 2 KB), its coordinates, slot
    and last-seen frame; each pixel's depth (f32) and RGB (3 B); every
    entry's mask byte; the pose, intrinsics and frame."""
    n_bytes = blocks * (4 * 512 * 4 + 12 + 4 + 4) + 7 * pixels \
        + n_visible + 84
    return bound_ms(n_bytes, blocks * 512 * OPS_PER_VOXEL)
