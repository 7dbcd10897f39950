"""Frozen copy of ``dynslam_tpu_torch/ops/stereo.py`` for the benchmark's plain
reference, which imports nothing of the port. Its docstring follows.

Dense census stereo — the port of ``dynslam_tpu/ops/stereo.py``.

1. census transform: a 7x7 window gives a 48-bit signature, held in one
   int64 per pixel (the JAX package's two int32 lanes side by side);
2. per-disparity Hamming cost by XOR and a SWAR popcount (PyTorch has no
   popcount), columns x < d cost 96;
3. 5x5 box aggregation (integer, zero padding), stored as int16;
4. winner-take-all (``argmin`` returns the first minimum, as
   ``jnp.argmin`` does), parabolic subpixel, a uniqueness ratio that
   excludes the +-1 neighbours, a left-right check, a 3x3 median and the
   optional gap fill.

The disparity sweep runs in chunks of 16 so the int64 signatures of one
chunk stay small; the (D, H, W) int16 volume itself (~119 MB at
128 x 375 x 1242) stays on the device. Integer costs make the winning
disparities exact against the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.config import StereoMatcherParams

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
#: cost of a column with no right-image counterpart (the JAX constant)
_NO_MATCH = 96
_BIG = 32767


def census_transform(gray: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W) float -> (H, W) int64 signature: bit k is set when the k-th
    window pixel (row-major, centre skipped) is darker than the centre;
    borders compare against zero padding."""
    h, w = gray.shape
    offsets = [(dy, dx) for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1) if (dy, dx) != (0, 0)]
    if len(offsets) > 63:
        raise ValueError("census window too large for one int64")
    padded = F.pad(gray, (radius, radius, radius, radius))
    sig = torch.zeros(h, w, dtype=torch.int64, device=gray.device)
    for k, (dy, dx) in enumerate(offsets):
        neigh = padded[radius + dy:radius + dy + h, radius + dx:radius + dx + w]
        sig |= (neigh < gray).to(torch.int64) << k
    return sig


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values below 2**63 (SWAR, no
    multiply), as int32."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Integer sum over a (2r+1)^2 window with zero padding, over the last
    two axes (separable prefix sums)."""
    k = 2 * radius + 1
    for dim in (-2, -1):
        pad = [0, 0, 0, 0]
        pad[0 if dim == -1 else 2] = radius + 1
        pad[1 if dim == -1 else 3] = radius
        c = torch.cumsum(F.pad(x, pad), dim=dim)
        n = x.shape[dim]
        x = c.narrow(dim, k, n) - c.narrow(dim, 0, n)
    return x


def cost_volume(cl: torch.Tensor, cr: torch.Tensor, max_disparity: int,
                aggregation_radius: int, chunk: int = 16) -> torch.Tensor:
    """(D, H, W) int16 aggregated census cost; right pixel x - d matches
    left x (``jnp.roll`` wrap, masked for x < d)."""
    h, w = cl.shape
    col = torch.arange(w, device=cl.device)
    out = torch.empty(max_disparity, h, w, dtype=torch.int16, device=cl.device)
    for d0 in range(0, max_disparity, chunk):
        ds = torch.arange(d0, min(d0 + chunk, max_disparity), device=cl.device)
        src = (col[None, :] - ds[:, None]) % w  # (CH, W)
        shifted = cr[:, src].permute(1, 0, 2)  # (CH, H, W)
        ham = popcount64(cl[None] ^ shifted)
        ham = torch.where(col[None, None, :] < ds[:, None, None],
                          _NO_MATCH, ham)
        out[d0:d0 + ds.shape[0]] = _box_sum(ham, aggregation_radius).to(
            torch.int16)
    return out


def compute_disparity(
    left_gray: torch.Tensor,  # (H, W) f32
    right_gray: torch.Tensor,  # (H, W) f32
    params: StereoMatcherParams,
) -> torch.Tensor:
    """Float32 disparity (H, W); invalid pixels are 0."""
    h, w = left_gray.shape
    D = params.max_disparity
    dev = left_gray.device
    costs = cost_volume(census_transform(left_gray, params.census_radius),
                        census_transform(right_gray, params.census_radius),
                        D, params.aggregation_radius)
    col = torch.arange(w, device=dev)[None, :].expand(h, w)

    best_d = torch.argmin(costs, dim=0)  # the first minimum
    c0 = costs.amin(0).to(torch.float32)
    cm = torch.gather(costs, 0, torch.clamp(best_d - 1, min=0)[None])[0]
    cp = torch.gather(costs, 0, torch.clamp(best_d + 1, max=D - 1)[None])[0]
    cm = torch.where(best_d == 0, c0, cm.to(torch.float32))
    cp = torch.where(best_d == D - 1, c0, cp.to(torch.float32))
    dd = torch.arange(D, device=dev)[:, None, None]
    second = torch.where((dd - best_d[None]).abs() > 1, costs,
                         _BIG).amin(0).to(torch.float32)

    denom = cm - 2.0 * c0 + cp
    offset = torch.where(denom > 1e-6,
                         0.5 * (cm - cp) / torch.clamp(denom, min=1e-6), 0.0)
    disp = best_d.to(torch.float32) + torch.clamp(offset, -0.5, 0.5)
    unique_ok = c0 <= params.uniqueness * second

    # left-right: cost_R(x, d) = cost_L(x + d, d); x >= w - d has none
    costs_r = torch.full_like(costs, _BIG)
    for d in range(D):
        costs_r[d, :, : w - d] = costs[d, :, d:]
    best_d_r = torch.argmin(costs_r, dim=0)
    disp_r_at = torch.gather(best_d_r, 1, (col - best_d) % w)
    lr_ok = (disp - disp_r_at.to(torch.float32)).abs() <= params.lr_max_diff

    in_range = (col >= D) | (best_d < col)
    valid = unique_ok & lr_ok & in_range & (best_d > 0)
    disp = torch.where(valid, disp, 0.0)

    if params.subpixel:
        padded = F.pad(disp[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        stacked = torch.stack([padded[dy:dy + h, dx:dx + w]
                               for dy in range(3) for dx in range(3)])
        disp = torch.sort(stacked, dim=0).values[4]

    if params.fill_gaps > 0:
        disp = fill_disparity_gaps(disp, params.fill_gaps)
    return disp.to(torch.float32)


def fill_disparity_gaps(disp: torch.Tensor, max_gap: int) -> torch.Tensor:
    """Fill horizontal invalid runs up to ``max_gap`` px with the smaller
    (background) flanking disparity; nearest valid values come from
    log2(W) shift-doubling passes, as in the JAX package."""
    h, w = disp.shape
    big = 1e9
    valid = disp > 0

    def from_left(x, k, pad):
        return torch.cat([torch.full((h, k), pad, dtype=x.dtype,
                                     device=x.device), x[:, :-k]], 1)

    def from_right(x, k, pad):
        return torch.cat([x[:, k:], torch.full((h, k), pad, dtype=x.dtype,
                                               device=x.device)], 1)

    v0 = torch.where(valid, disp, 0.0)
    d0 = torch.where(valid, 0.0, big)

    def nearest(shift):
        vals, dist = v0, d0
        k = 1
        while k < w:
            sv = shift(vals, k, 0.0)
            sd = shift(dist, k, big) + k
            take = sd < dist
            vals = torch.where(take, sv, vals)
            dist = torch.where(take, sd, dist)
            k *= 2
        return vals, dist

    lv, ldist = nearest(from_left)
    rv, rdist = nearest(from_right)
    fill = torch.minimum(torch.where(lv > 0, lv, big),
                         torch.where(rv > 0, rv, big))
    run_ok = (ldist + rdist - 1 <= max_gap) & (lv > 0) & (rv > 0)
    return torch.where(~valid & run_ok, fill, disp)
