"""Dense census stereo — the port of ``dynslam_tpu/ops/stereo.py``.

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

``compute_disparity`` dispatches on the device of its images: CPU tensors
take the plain version ``compute_disparity_plain``; CUDA tensors take the
kernels of ``csrc/stereo.cu`` (census, cost volume, both winner-take-alls
with the checks, median: four launches, three without the median), equal
to the plain version bit for bit, and a failed build or launch raises.
The optional gap fill stays in PyTorch after them. ``depth_m_from_stereo``
is ``ops/depth.py``'s conversion of that disparity to metres, which on
CUDA the last kernel computes as it writes the disparity. ``launches``
counts the kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dynslam_tpu_torch.config import StereoMatcherParams
from dynslam_tpu_torch.ops import cuda_build
from dynslam_tpu_torch.ops import depth as depth_ops

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
#: cost of a column with no right-image counterpart (the JAX constant)
_NO_MATCH = 96
_BIG = 32767

#: kernel launches of ``compute_disparity`` on CUDA tensors (four a call
#: with the median, three without)
launches = 0


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


def compute_disparity_plain(
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


#: the kernels' limits (``csrc/stereo.cu``): the cost tile is 32 columns
#: with the aggregation window's halo, and the select kernel keeps 12
#: bytes a column of a row in shared memory (227 KB)
_MAX_AGG_RADIUS = 15
_MAX_WIDTH = 232_448 // 12


def _check_args(left: torch.Tensor, right: torch.Tensor,
                params: StereoMatcherParams) -> None:
    """Raise ValueError on what the plain version raises on and on what
    the kernels do not take: two float32 (H, W) images of one shape on one
    device, contiguous, H and W at least 1; 1 <= max_disparity <= W; a
    census window of at most 63 bits (radius <= 3), radii not negative;
    on CUDA an aggregation radius of at most 15 and W of at most 19,370."""
    if left.dim() != 2 or left.dtype != torch.float32 \
            or right.shape != left.shape or right.dtype != left.dtype:
        raise ValueError("compute_disparity: the images must be float32 "
                         f"(H, W) of one shape, got {left.dtype} "
                         f"{tuple(left.shape)} and {right.dtype} "
                         f"{tuple(right.shape)}")
    h, w = left.shape
    if h < 1 or w < 1:
        raise ValueError("compute_disparity: H and W must be at least 1")
    if right.device != left.device:
        raise ValueError(f"compute_disparity: right image on {right.device}"
                         f", left on {left.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("compute_disparity: the images must be contiguous")
    if not 1 <= params.max_disparity <= w:
        raise ValueError(f"compute_disparity: max_disparity "
                         f"{params.max_disparity} outside 1..W ({w})")
    if params.census_radius < 0 or params.aggregation_radius < 0:
        raise ValueError("compute_disparity: negative radius")
    if (2 * params.census_radius + 1) ** 2 - 1 > 63:
        # the plain version's own rule (census_transform)
        raise ValueError("census window too large for one int64")
    if left.device.type == "cuda" and (
            params.aggregation_radius > _MAX_AGG_RADIUS or w > _MAX_WIDTH):
        raise ValueError(f"compute_disparity: the kernels take an "
                         f"aggregation radius up to {_MAX_AGG_RADIUS} and W "
                         f"up to {_MAX_WIDTH}, got "
                         f"{params.aggregation_radius} and {w}")


class _Launches(NamedTuple):
    """The kernels' C call, prepared (``cuda_build.Launch``: one call
    launches ``kernels`` kernels), the disparity it writes and its depth
    (m), None where the call was prepared without one."""

    call: cuda_build.Launch
    kernels: int
    out: torch.Tensor
    depth: Optional[torch.Tensor]


def launch_args(left: torch.Tensor, right: torch.Tensor,
                params: StereoMatcherParams,
                depth: Optional[Tuple[float, float, float]] = None
                ) -> _Launches:
    """The C call of a whole call's kernels over two checked CUDA images,
    ready to run on the current stream, with the scratch and outputs it
    fills (no launch). ``depth`` = (bf, min_depth_m, max_depth_m): the
    last kernel also writes ``depth_m_from_mm(depth_mm_from_disparity(
    disp, bf, min_depth_m, max_depth_m))``."""
    dev = left.device
    h, w = left.shape
    D = params.max_disparity
    median = bool(params.subpixel)
    census = torch.empty(2, h, w, dtype=torch.int64, device=dev)
    cost = torch.empty(h, w, D, dtype=torch.int16, device=dev)
    masked = torch.empty(h, w, dtype=torch.float32, device=dev) \
        if median else None
    out = torch.empty(h, w, dtype=torch.float32, device=dev)
    depth_m, conv = None, (0.0, 0.0, 0, 0, 0.0)
    if depth is not None:
        bf, min_depth_m, max_depth_m = depth
        depth_m = torch.empty(h, w, dtype=torch.float32, device=dev)
        # mm = MM_PER_M * (bf / disp) (scale 1), the range in whole mm,
        # metres = mm * M_PER_MM
        conv = (float(bf), depth_ops.MM_PER_M,
                *depth_ops.mm_range(min_depth_m, max_depth_m),
                depth_ops.M_PER_MM)
    fn = cuda_build.function("stereo", "dynslam_stereo_disparity",
                             "pp iiiii ff i ppppp ff ii f p")

    def ptr(t):
        return None if t is None else t.data_ptr()

    call = cuda_build.Launch(fn, (
        left.data_ptr(), right.data_ptr(), h, w, D, params.census_radius,
        params.aggregation_radius, params.uniqueness, params.lr_max_diff,
        int(median), census.data_ptr(), cost.data_ptr(),
        ptr(masked), out.data_ptr(), ptr(depth_m), *conv,
        torch.cuda.current_stream(dev).cuda_stream),
        (left, right, census, cost, masked, out, depth_m))
    return _Launches(call, 4 if median else 3, out, depth_m)


def compute_disparity(
    left_gray: torch.Tensor,  # (H, W) f32
    right_gray: torch.Tensor,  # (H, W) f32
    params: StereoMatcherParams,
) -> torch.Tensor:
    """Float32 disparity (H, W); invalid pixels are 0
    (``compute_disparity_plain`` for the rule). CPU tensors: the plain
    version; CUDA tensors: the kernels of ``csrc/stereo.cu``, no host
    sync, then the gap fill in PyTorch where ``fill_gaps`` asks for it.
    The arguments are checked first on either device."""
    _check_args(left_gray, right_gray, params)
    dev = left_gray.device
    if dev.type == "cpu":
        return compute_disparity_plain(left_gray, right_gray, params)
    if dev.type != "cuda":
        raise ValueError(f"compute_disparity: unsupported device {dev}")
    run = _launch(left_gray, right_gray, params)
    if params.fill_gaps > 0:
        return fill_disparity_gaps(run.out, params.fill_gaps)
    return run.out


def _launch(left: torch.Tensor, right: torch.Tensor,
            params: StereoMatcherParams,
            depth: Optional[Tuple[float, float, float]] = None
            ) -> _Launches:
    """Run a call's kernels (``launch_args``) and count them."""
    global launches
    run = launch_args(left, right, params, depth)
    cuda_build.check_launch(run.call(), "stereo")
    launches += run.kernels
    return run


def depth_m_from_stereo(
    left_gray: torch.Tensor,  # (H, W) f32
    right_gray: torch.Tensor,  # (H, W) f32
    params: StereoMatcherParams,
    bf: float,
    min_depth_m: float,
    max_depth_m: float,
) -> torch.Tensor:
    """Float32 depth (m) of ``compute_disparity``'s disparity,
    ``depth_m_from_mm(depth_mm_from_disparity(disp, bf, min_depth_m,
    max_depth_m))``, 0 where invalid. On CUDA without the gap fill the
    stereo kernels compute it as they write the disparity (no launch of
    its own); else those two functions run on the disparity."""
    _check_args(left_gray, right_gray, params)
    if left_gray.device.type == "cuda" and params.fill_gaps <= 0:
        return _launch(left_gray, right_gray, params,
                       (bf, min_depth_m, max_depth_m)).depth
    disp = compute_disparity(left_gray, right_gray, params)
    return depth_ops.depth_m_from_mm(depth_ops.depth_mm_from_disparity(
        disp, bf, min_depth_m, max_depth_m))


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
