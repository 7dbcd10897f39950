"""Frozen copy of ``dynslam_tpu_torch/ops/tsdf.py`` for the benchmark's plain
reference, which imports nothing of the port. Its docstring follows.

Voxel-block TSDF map — the port of ``dynslam_tpu/ops/tsdf.py``.

The data layout and rules carry over unchanged:

- a fixed-capacity struct-of-arrays block pool: ``tsdf_w`` (P, 512) int32
  holds (sdf_i16 << 16) | weight_u16 per voxel, ``color`` (P, 512) int32
  holds 0x00RRGGBB, plus per-block world coords, allocation frame,
  last-seen frame and validity. Row P-1 is a reserved scratch row;
- a frustum-local dense index ``grid`` of ``local_dims`` block cells
  anchored at an ``origin``: ``grid[cell] = pool slot`` or -1;
- allocation of the truncation band [d - mu, d + mu] at stride 4 with
  ascending slot assignment, the visible-block list, decay GC and the
  memory statistics.

Fusion (``ops/integrate.py``) and the full-frame raycast
(``ops/raycast.py``) live beside their CUDA kernels. ``raycast`` here is
the JAX package's dense free-camera tracer (``compute_block_df`` and a
distance-field march at any image size): XLA there, plain PyTorch here,
on the state's device.

The pool is updated IN PLACE (``allocate``, ``decay``, and fusion write
into the state's tensors); this replaces the JAX package's
``donate_argnames``. Callers that need the old map copy it first.

Compaction is an ascending, fixed-size ``nonzero`` built from a cumsum
and a scatter, so it needs no device-to-host sync; the JAX package's
``top_k`` trick (``compact_mask``) is a TPU workaround and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference._util import constant

BLOCK = 8
BLOCK3 = BLOCK ** 3

# packed voxel: (sdf_i16 << 16) | weight_u16
SDF_SCALE = 32767.0
WEIGHT_SCALE = 64.0
EMPTY_VOXEL = 32767 << 16


def pack_voxel(sdf: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """float sdf in [-1, 1] and weight -> packed int32. ``s * 65536 + w``
    equals ``(s << 16) | w`` and stays inside int32 for s in [-32767,
    32767], w in [0, 65535]."""
    s = torch.clamp(torch.round(sdf * SDF_SCALE), -32767, 32767).to(torch.int32)
    w = torch.clamp(torch.round(weight * WEIGHT_SCALE), 0, 65535).to(torch.int32)
    return s * 65536 + w


def unpack_sdf(v: torch.Tensor) -> torch.Tensor:
    return (v >> 16).to(torch.float32) / SDF_SCALE


def unpack_weight(v: torch.Tensor) -> torch.Tensor:
    return (v & 0xFFFF).to(torch.float32) / WEIGHT_SCALE


def pack_rgb(rgb_f32: torch.Tensor) -> torch.Tensor:
    """(..., 3) float [0, 255] -> packed int32 0x00RRGGBB."""
    c = torch.clamp(rgb_f32 + 0.5, 0, 255).to(torch.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_rgb(packed: torch.Tensor) -> torch.Tensor:
    """packed int32 -> (..., 3) uint8."""
    return torch.stack(
        [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], -1
    ).to(torch.uint8)


def compact_mask(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """Indices of the True entries of a bool mask along its last axis,
    ascending, cut or padded to ``size`` with ``fill_value`` (int64) —
    ``torch.nonzero`` order at a fixed size, without a host sync."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask.to(torch.int64), -1) - 1
    pos = torch.where(mask & (rank < size), rank, size)
    out = torch.full((*mask.shape[:-1], size + 1), fill_value,
                     dtype=torch.int64, device=mask.device)
    out.scatter_(-1, pos, torch.arange(n, dtype=torch.int64,
                                       device=mask.device).expand_as(pos))
    return out[..., :size]


@dataclass(frozen=True)
class TsdfConfig:
    """Static engine configuration; the same fields and defaults as the
    JAX package's ``TsdfConfig`` (``convert.tsdf_config_from_jax`` copies
    one into the other)."""

    pool_capacity: int = 65536
    local_dims: Tuple[int, int, int] = (128, 48, 128)
    max_new_blocks: int = 8192
    max_visible_blocks: int = 16384
    voxel_size: float = 0.05
    mu: float = 0.30
    max_weight: float = 100.0
    min_depth: float = 0.5
    max_depth: float = 20.0
    use_depth_weighting: bool = False
    raycast_coarse_steps: int = 24
    raycast_fine_steps: int = 20
    df_cap: int = 8
    raycast_cand_k: int = 64
    alloc_band_samples: int = 4
    width: int = 1242
    height: int = 375
    fx: float = 707.0912
    fy: float = 707.0912
    cx: float = 601.8873
    cy: float = 183.1104

    @property
    def block_size(self) -> float:
        return self.voxel_size * BLOCK

    @property
    def n_cells(self) -> int:
        dx, dy, dz = self.local_dims
        return dx * dy * dz


@dataclass
class TsdfState:
    """The map: a struct-of-arrays voxel-block pool, updated in place."""

    tsdf_w: torch.Tensor  # (P, 512) int32 packed (sdf_i16 << 16 | w_u16)
    color: torch.Tensor  # (P, 512) int32 packed 0x00RRGGBB
    block_coords: torch.Tensor  # (P, 3) int32 world block coords
    alloc_frame: torch.Tensor  # (P,) int32
    last_seen: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool
    decayed_blocks: torch.Tensor  # () int32 cumulative blocks freed by decay

    @property
    def device(self) -> torch.device:
        return self.tsdf_w.device

    def clone(self) -> "TsdfState":
        return TsdfState(*(getattr(self, f.name).clone() for f in fields(self)))


class Raycast(NamedTuple):
    depth: torch.Tensor  # (H, W) f32 z-depth, 0 = miss
    points: torch.Tensor  # (H, W, 3) f32 world-frame hit points
    color: torch.Tensor  # (H, W, 3) uint8
    weight: torch.Tensor  # (H, W) f32 voxel weight at the hit
    hit: torch.Tensor  # (H, W) bool
    #: () int64: samples the rays executed in this render
    march_samples: torch.Tensor


def create_state(cfg: TsdfConfig, device) -> TsdfState:
    """An empty pool. The LAST row is a reserved scratch slot: valid, so
    the allocator never hands it out, with far-away coords, so it is never
    in any local window or frustum."""
    P = cfg.pool_capacity
    # fill_ takes the value as a kernel argument; an element assignment
    # would copy it from host memory and wait for the stream
    valid = torch.zeros(P, dtype=torch.bool, device=device)
    valid[P - 1:].fill_(True)
    coords = torch.zeros(P, 3, dtype=torch.int32, device=device)
    coords[P - 1:].fill_(1 << 24)
    return TsdfState(
        tsdf_w=torch.full((P, BLOCK3), EMPTY_VOXEL, dtype=torch.int32,
                          device=device),
        color=torch.zeros(P, BLOCK3, dtype=torch.int32, device=device),
        block_coords=coords,
        alloc_frame=torch.zeros(P, dtype=torch.int32, device=device),
        last_seen=torch.zeros(P, dtype=torch.int32, device=device),
        valid=valid,
        decayed_blocks=torch.zeros((), dtype=torch.int32, device=device),
    )


def create_pool(cfg: TsdfConfig, n: int, device) -> TsdfState:
    """``n`` empty maps stacked on a leading axis (every field gains it):
    the pooled object volumes of the dynamic step."""
    one = create_state(cfg, device)
    return TsdfState(*(getattr(one, f.name).expand(n, *getattr(
        one, f.name).shape).contiguous() for f in fields(one)))


def pool_slot(pool: TsdfState, s: int) -> TsdfState:
    """Slot ``s`` of a stacked pool as a ``TsdfState`` of views: the
    in-place updates of ``allocate``, ``decay`` and fusion land in the
    pool."""
    return TsdfState(*(getattr(pool, f.name)[s] for f in fields(pool)))


def assign_state(dst: TsdfState, src: TsdfState) -> None:
    """Copy ``src`` into ``dst`` in place (e.g. a fresh map into a pool
    slot)."""
    for f in fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


# ---------------------------------------------------------------------------
# local grid
# ---------------------------------------------------------------------------


def grid_linear(cfg: TsdfConfig, local: torch.Tensor):
    """(..., 3) local block coords -> (linear cell index, in_window);
    out-of-window coords map to n_cells."""
    dx, dy, dz = cfg.local_dims
    in_win = (
        (local[..., 0] >= 0) & (local[..., 0] < dx)
        & (local[..., 1] >= 0) & (local[..., 1] < dy)
        & (local[..., 2] >= 0) & (local[..., 2] < dz)
    )
    lin = (local[..., 0] * dy + local[..., 1]) * dz + local[..., 2]
    return torch.where(in_win, lin, cfg.n_cells), in_win


def compute_origin(cfg: TsdfConfig, cam_to_world: torch.Tensor) -> torch.Tensor:
    """Anchor the local window around the camera, biased along the viewing
    direction. Returns (3,) int32."""
    campos = cam_to_world[:3, 3]
    forward = cam_to_world[:3, 2]
    extent = constant(cfg.local_dims, torch.float32,
                      cam_to_world.device) * cfg.block_size
    center = campos + forward * extent * 0.35
    origin = torch.floor((center - extent / 2.0) / cfg.block_size)
    return origin.to(torch.int32)


def build_local_grid(cfg: TsdfConfig, state: TsdfState,
                     origin: torch.Tensor) -> torch.Tensor:
    """Scatter pool slots into a fresh dense local index cache (one O(P)
    scatter, no hash probes). Returns (n_cells,) int32."""
    n_cells = cfg.n_cells
    local = state.block_coords - origin[None, :]
    lin, in_win = grid_linear(cfg, local)
    lin = torch.where(state.valid & in_win, lin, n_cells).to(torch.int64)
    grid = torch.full((n_cells + 1,), -1, dtype=torch.int32, device=state.device)
    slots = torch.arange(cfg.pool_capacity, dtype=torch.int32,
                         device=state.device)
    # valid in-window blocks have distinct cells; every dropped slot
    # writes the dump cell n_cells
    grid.index_put_((lin,), slots)
    return grid[:n_cells].clone()


def _rows_where(cond: torch.Tensor, rows: torch.Tensor,
                fallback_row: torch.Tensor) -> torch.Tensor:
    """``cond`` (N,) selects between (N, ...) rows and one fallback row."""
    shape = (-1,) + (1,) * (rows.dim() - 1)
    return torch.where(cond.view(shape), rows, fallback_row)


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """In place ``dst[idx[ok]] = rows[ok]`` without a host sync: entries
    that are not ok rewrite the scratch row P-1 with its own value."""
    scratch = dst.shape[0] - 1
    safe = torch.where(ok, idx, scratch).to(torch.int64)
    dst.index_put_((safe,), _rows_where(ok, rows, dst[scratch]))


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------


def frame_tensor(frame_idx, shape, device) -> torch.Tensor:
    """``frame_idx`` (int or 0-d tensor) as an int32 tensor of ``shape``;
    an int is filled in on the device, with no host-to-device copy."""
    if torch.is_tensor(frame_idx):
        return frame_idx.to(device=device, dtype=torch.int32).expand(shape)
    return torch.full(shape, int(frame_idx), dtype=torch.int32, device=device)


def _intrinsics(cfg: TsdfConfig, intr4: Optional[torch.Tensor]):
    if intr4 is None:
        return cfg.fx, cfg.fy, cfg.cx, cfg.cy
    return intr4[0], intr4[1], intr4[2], intr4[3]


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64, so only the sum
    rounds (to float64, then float32 — a double rounding that differs
    from a true fma only when the float64 sum lies exactly halfway
    between two float32 values)."""
    def f64(x):
        return x.double() if torch.is_tensor(x) else x
    return (f64(a) * f64(b) + f64(c)).float()


def recip32(x: float) -> float:
    """1 / x rounded in float32, the constant XLA multiplies by where the
    JAX code divides by a constant."""
    return float(np.float32(1.0) / np.float32(x))


def transform_points(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p @ M[:3, :3].T + M[:3, 3]`` for (..., 3) points, in the order
    XLA's CPU backend evaluates the JAX package's small matmul: a chain
    of fused multiply-adds over the row, then the translation."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [fma(M[i, 2], z, fma(M[i, 1], y, M[i, 0] * x)) + M[i, 3]
         for i in range(3)],
        -1,
    )


def allocate(
    cfg: TsdfConfig,
    state: TsdfState,
    grid: torch.Tensor,
    origin: torch.Tensor,
    depth_m: torch.Tensor,  # (H, W) float, 0 = invalid
    cam_to_world: torch.Tensor,
    frame_idx,
    intr4: Optional[torch.Tensor] = None,
):
    """Allocate the blocks the depth map's truncation band touches.
    Updates ``state`` in place; returns (state, grid, (n_new, n_dropped))
    with a new grid."""
    fx, fy, cx, cy = _intrinsics(cfg, intr4)
    dev = depth_m.device
    n_cells = cfg.n_cells
    dx, dy, dz = cfg.local_dims
    P = cfg.pool_capacity

    # stride-4 ray sampling: a block's footprint is >= ~14 px even at
    # max_depth, so a 4 px grid still puts several samples in every block
    depth_m = depth_m[::4, ::4]
    h, w = depth_m.shape
    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) * 4.0
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) * 4.0
    valid_px = (depth_m >= cfg.min_depth) & (depth_m <= cfg.max_depth)
    ray_x = (uu - cx) / fx
    ray_y = (vv - cy) / fy

    n_samples = cfg.alloc_band_samples
    lins = []
    for i in range(n_samples):
        z = depth_m + cfg.mu * (2.0 * i / (n_samples - 1) - 1.0)
        z = torch.clamp(z, min=0.05)
        pcam = torch.stack([ray_x * z, ray_y * z, z], -1)
        pw = transform_points(cam_to_world, pcam)
        blk = torch.floor(pw * recip32(cfg.block_size)).to(torch.int32)
        lin, in_win = grid_linear(cfg, blk - origin)
        lins.append(torch.where(valid_px & in_win, lin, n_cells).reshape(-1))
    wanted = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    # index_fill_ takes the value as a scalar argument; ``wanted[i] = True``
    # would copy it from host memory and so wait for the stream
    wanted.index_fill_(0, torch.cat(lins).to(torch.int64), True)
    wanted = wanted[:n_cells]

    missing = wanted & (grid < 0)
    cell_ids = compact_mask(missing, cfg.max_new_blocks, n_cells)
    is_new = cell_ids < n_cells
    n_new = is_new.sum(dtype=torch.int32)

    free_slots = compact_mask(~state.valid, cfg.max_new_blocks, P)
    has_free = free_slots < P
    usable = is_new & has_free
    n_dropped = n_new - usable.sum(dtype=torch.int32)

    lx = cell_ids // (dy * dz)
    ly = (cell_ids // dz) % dy
    lz = cell_ids % dz
    new_coords = (torch.stack([lx, ly, lz], -1) + origin[None, :]).to(torch.int32)

    k = cfg.max_new_blocks
    frame = frame_tensor(frame_idx, (k,), dev)
    scatter_rows(state.valid, free_slots, usable,
                 torch.ones(k, dtype=torch.bool, device=dev))
    scatter_rows(state.block_coords, free_slots, usable, new_coords)
    scatter_rows(state.alloc_frame, free_slots, usable, frame)
    scatter_rows(state.last_seen, free_slots, usable, frame)
    scatter_rows(state.tsdf_w, free_slots, usable,
                 torch.full((k, BLOCK3), EMPTY_VOXEL, dtype=torch.int32,
                            device=dev))
    scatter_rows(state.color, free_slots, usable,
                 torch.zeros(k, BLOCK3, dtype=torch.int32, device=dev))

    cell_safe = torch.where(usable, cell_ids, n_cells)
    grid = torch.cat([grid, torch.full((1,), -1, dtype=torch.int32, device=dev)])
    grid.index_put_((cell_safe,), free_slots.to(torch.int32))
    return state, grid[:n_cells].clone(), (n_new, n_dropped)


# ---------------------------------------------------------------------------
# visibility
# ---------------------------------------------------------------------------


def visible_blocks(
    cfg: TsdfConfig,
    state: TsdfState,
    grid: torch.Tensor,
    origin: torch.Tensor,
    world_to_cam: torch.Tensor,
    intr4: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool slots whose block center projects into the (margin-padded)
    frustum and lies in the local window. Returns (slots (V,) int32,
    mask (V,) bool), ascending, padded with ``pool_capacity``."""
    fx, fy, cx, cy = _intrinsics(cfg, intr4)
    centers = (state.block_coords.to(torch.float32) + 0.5) * cfg.block_size
    pc = transform_points(world_to_cam, centers)
    z = pc[:, 2]
    zc = torch.clamp(z, min=0.3)
    margin_px = BLOCK * 1.8 / zc * fx * cfg.voxel_size
    u = pc[:, 0] / zc * fx + cx
    v = pc[:, 1] / zc * fy + cy
    half_diag = cfg.block_size
    in_frustum = (
        (z > cfg.min_depth - half_diag)
        & (z < cfg.max_depth + half_diag + cfg.mu)
        & (u > -margin_px) & (u < cfg.width + margin_px)
        & (v > -margin_px) & (v < cfg.height + margin_px)
    )
    _, in_win = grid_linear(cfg, state.block_coords - origin[None, :])
    sel = state.valid & in_frustum & in_win
    slots = compact_mask(sel, cfg.max_visible_blocks, cfg.pool_capacity)
    mask = slots < cfg.pool_capacity
    return slots.to(torch.int32), mask


# ---------------------------------------------------------------------------
# the dense free-camera tracer
# ---------------------------------------------------------------------------


def compute_block_df(cfg: TsdfConfig, grid: torch.Tensor) -> torch.Tensor:
    """Capped Chebyshev distance, in blocks, from each local-grid cell to
    the nearest allocated one: 0 on an allocated cell, k where none lies
    within k - 1 cells, at most ``df_cap``. ``df_cap - 1`` min-dilations
    over the 3x3x3 neighbourhood (a min is exact in any order). Returns
    (n_cells,) int8."""
    occ = (grid >= 0).view(1, 1, *cfg.local_dims)
    d = torch.where(occ, 0.0, float(cfg.df_cap))
    for _ in range(cfg.df_cap - 1):
        d = torch.minimum(d, 1.0 - F.max_pool3d(-d, 3, 1, 1))
    return d.reshape(-1).to(torch.int8)


def _rotate(M: torch.Tensor, x, y, z):
    """``[x, y, z] @ M[:3, :3].T`` per component, in ``transform_points``'
    order (a chain of fused multiply-adds over the row)."""
    return [fma(M[i, 2], z, fma(M[i, 1], y, M[i, 0] * x)) for i in range(3)]


def raycast(
    cfg: TsdfConfig,
    state: TsdfState,
    grid: torch.Tensor,  # (n_cells,) int32
    origin: torch.Tensor,  # (3,) int32
    cam_to_world: torch.Tensor,  # (4, 4) f32
    intrinsics: torch.Tensor,  # (4,) f32 fx, fy, cx, cy
    width: Optional[int] = None,
    height: Optional[int] = None,
) -> Raycast:
    """The JAX package's two-phase dense tracer (``tsdf.raycast``) at any
    image size, on the state's device:

    - coarse, at half resolution: a march over the block distance field,
      leaping (df - 0.5) blocks a step, until an allocated block; the
      entry t upsampled as the minimum over each 3x3 neighbourhood, less
      one block;
    - fine: a sphere trace of the packed TSDF from there, the first
      confident +/- crossing interpolated linearly; colour and weight
      read at the interpolated hit.

    Rays start where they enter the local window. Divisions by a constant
    are multiplications by its float32 reciprocal and ``a * b + c`` one
    fused multiply-add, as XLA computes them."""
    w = width or cfg.width
    h = height or cfg.height
    dev = state.device
    n_cells = cfg.n_cells
    block = cfg.block_size
    inv_block, inv_voxel = recip32(block), recip32(cfg.voxel_size)
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    R = cam_to_world[:3, :3]
    cam_pos = cam_to_world[:3, 3]
    # world-frame directions, z-normalised (|rd| != 1), so t is z-depth
    rd = torch.stack(_rotate(R, (uu - cx) / fx, (vv - cy) / fy,
                             torch.ones_like(uu)), -1)

    df = compute_block_df(cfg, grid)
    grid_ext = torch.cat([grid, grid.new_full((1,), -1)])
    df_ext = torch.cat([df, df.new_full((1,), cfg.df_cap)])
    packed_flat = state.tsdf_w.reshape(-1)
    P = cfg.pool_capacity

    t_min = float(np.float32(cfg.min_depth * 0.6))
    t_max = float(np.float32(cfg.max_depth * 1.05))

    # the ray's t interval inside the local window's box
    box_lo = origin.to(torch.float32) * block
    box_hi = box_lo + constant(cfg.local_dims, torch.float32, dev) * block
    inv_d = 1.0 / torch.where(rd.abs() < 1e-9, 1e-9, rd)
    t1 = (box_lo - cam_pos) * inv_d
    t2 = (box_hi - cam_pos) * inv_d
    t_enter = torch.clamp(torch.minimum(t1, t2).amax(-1), min=t_min)
    t_leave = torch.clamp(torch.maximum(t1, t2).amin(-1), max=t_max)

    def at(dirs, t):
        return fma(dirs, t[..., None], cam_pos)

    def cell_index(pos):
        blk = torch.floor(pos * inv_block).to(torch.int32)
        lin, in_win = grid_linear(cfg, blk - origin)
        return lin.to(torch.int64), in_win

    # -- coarse phase at half resolution -----------------------------------
    rd_c = rd[::2, ::2]
    t_leave_c = t_leave[::2, ::2]
    t = t_enter[::2, ::2]
    entered = torch.zeros_like(t, dtype=torch.bool)
    t_entry = torch.zeros_like(t)
    samples = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(cfg.raycast_coarse_steps):
        samples += (~entered & (t <= t_leave_c)).sum()
        lin, in_win = cell_index(at(rd_c, t))
        dfv = df_ext[lin].to(torch.float32)
        hit_now = (dfv <= 0.5) & in_win & ~entered & (t <= t_leave_c)
        t_entry = torch.where(hit_now, t, t_entry)
        entered = entered | hit_now
        t = torch.where(entered | (t > t_leave_c), t,
                        fma(torch.clamp(dfv - 0.5, min=0.6),
                            float(np.float32(block)), t))

    # conservative upsample: the 3x3 minimum, less one block of margin
    t_entry_inf = torch.where(entered, t_entry, float("inf"))
    t_entry_min = -F.max_pool2d(-t_entry_inf[None], 3, 1, 1)[0]
    t_entry = t_entry_min.repeat_interleave(2, 0).repeat_interleave(2, 1)[
        :h, :w] - 0.6 * block
    entered = torch.isfinite(t_entry)
    t_entry = torch.where(entered, torch.maximum(t_entry, t_enter), 0.0)

    # -- fine phase: sphere trace of the packed voxels ---------------------
    def sample(pos):
        lin, in_win = cell_index(pos)
        slot = grid_ext[lin]
        vox_c = torch.floor(pos * inv_voxel).to(torch.int32)
        lv = vox_c - torch.floor(pos * inv_block).to(torch.int32) * BLOCK
        vidx = (lv[..., 0] * BLOCK + lv[..., 1]) * BLOCK + lv[..., 2]
        flat = torch.clamp(slot, 0, P - 1).to(torch.int64) * BLOCK3 + vidx
        ok = (slot >= 0) & in_win
        packed = torch.where(ok, packed_flat[flat], EMPTY_VOXEL)
        sdf = (packed >> 16).to(torch.float32) * recip32(SDF_SCALE)
        return sdf, unpack_weight(packed), torch.where(ok, flat, 0), ok

    mu = cfg.mu
    t = torch.where(entered, torch.clamp(t_entry, min=t_min), t_max + 1.0)
    prev_sdf = torch.ones_like(t)
    prev_t = t
    hit_t = torch.zeros_like(t)
    hit_flat = torch.zeros(h, w, dtype=torch.int64, device=dev)
    found = torch.zeros(h, w, dtype=torch.bool, device=dev)
    for _ in range(cfg.raycast_fine_steps):
        active = ~found & (t <= t_leave)
        samples += active.sum()
        sdf, wv, flat, alloc = sample(at(rd, t))
        confident = alloc & (wv > 0)
        crossing = (prev_sdf > 0.0) & (sdf <= 0.0) & confident & active
        denom = prev_sdf - sdf
        frac = torch.where(denom > 1e-6,
                           prev_sdf / torch.clamp(denom, min=1e-6), 0.0)
        hit_t = torch.where(crossing, fma(t - prev_t, frac, prev_t), hit_t)
        hit_flat = torch.where(crossing, flat, hit_flat)
        found = found | crossing
        step = torch.where(confident,
                           torch.clamp(sdf * mu * 0.9,
                                       min=cfg.voxel_size * 1.5),
                           0.75 * block)
        prev_sdf = torch.where(confident, sdf, 1.0)
        prev_t = t
        t = torch.where(found, t, t + step)

    hit = found & (hit_t < t_max) & (hit_t > 0)
    depth = torch.where(hit, hit_t, 0.0)
    points = at(rd, hit_t)
    # colour and weight at the interpolated hit's voxel (the crossing
    # sample can sit a step behind the surface, outside the colour band)
    _, _, flat_at_hit, ok_at_hit = sample(points)
    hit_flat = torch.where(ok_at_hit, flat_at_hit, hit_flat)
    color = torch.where(hit[..., None],
                        unpack_rgb(state.color.reshape(-1)[hit_flat]), 0)
    weight = torch.where(hit, unpack_weight(packed_flat[hit_flat]), 0.0)
    return Raycast(depth=depth, points=points, color=color.to(torch.uint8),
                   weight=weight, hit=hit, march_samples=samples)


# ---------------------------------------------------------------------------
# decay (voxel GC)
# ---------------------------------------------------------------------------


def decay(
    cfg: TsdfConfig,
    state: TsdfState,
    frame_idx,
    max_decay_weight: float,
    min_decay_age,
    force_all: bool = False,
):
    """In blocks old enough (age >= min_decay_age, or all with
    ``force_all``), delete voxels whose weight is in (0, max_decay_weight];
    reclaim blocks left empty. In place; returns (state, n_freed)."""
    if force_all:
        eligible = state.valid.clone()
    else:
        eligible = state.valid & ((frame_idx - state.alloc_frame) >= min_decay_age)
    wbits = state.tsdf_w & 0xFFFF
    w_thresh = int(round(float(max_decay_weight) * WEIGHT_SCALE))
    kill = eligible[:, None] & (wbits > 0) & (wbits <= w_thresh)
    state.tsdf_w.masked_fill_(kill, EMPTY_VOXEL)
    emptied = eligible & ((state.tsdf_w & 0xFFFF) == 0).all(dim=1)
    emptied[-1:].fill_(False)  # never the reserved scratch row
    n_freed = emptied.sum(dtype=torch.int32)
    state.valid &= ~emptied
    state.decayed_blocks += n_freed
    return state, n_freed


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

#: packed int32 sdf+weight (4 B) + packed int32 rgb (4 B) per voxel
BYTES_PER_VOXEL = 8


def memory_stats(cfg: TsdfConfig, state: TsdfState):
    """(used_blocks, used_bytes, cum_decayed_blocks, saved_bytes) as 0-d
    tensors (InfiniTamDriver.h:241-250 semantics)."""
    used = state.valid.sum(dtype=torch.int32) - 1  # minus the scratch row
    block_bytes = BLOCK3 * BYTES_PER_VOXEL
    return (used, used * block_bytes, state.decayed_blocks,
            state.decayed_blocks * block_bytes)
