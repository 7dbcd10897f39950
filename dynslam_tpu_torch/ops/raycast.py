"""Full-frame TSDF raycast: the CUDA kernel ``csrc/raycast.cu`` and its
plain PyTorch version ``raycast_ref``.

Replaces ``dynslam_tpu/ops/pallas_raycast.py::raycast_tiled``. The march
rule is the Pallas kernel's, with the per-tile top-K candidate lists
replaced by a per-slot candidate flag looked up through the dense local
grid:

- a block is a candidate when it is visible, holds a stored negative
  voxel (a zero crossing needs one) and lies in depth range
  (``candidate_flags``); every other voxel reads sdf = +1;
- rays (z-normalised, so t is z-depth) start at the first candidate block
  at or after t_min = 0.6 min_depth and stop at t_cap = 1.05 max_depth +
  2 dt, dt = 2.5 voxel;
- inside candidate blocks they sphere-step by max(0.9 mu sdf, dt); where
  the next position is not covered they leap to the next candidate
  block's entry minus dt/4 (at least t + dt/2), found by a bounded 3-D
  DDA over the grid cells;
- the first +->- crossing wins, interpolated linearly against the
  previous sample (clamped to 1.5 dt back) and polished by one Newton
  step clipped to +-2.5 voxels;
- colour and weight are read at the hit, falling back to the crossing
  sample and then to one dt in front of it.

``raycast_ref`` computes exactly this rule, vectorised over pixels with
a Python loop over steps, in the kernel's operation order; the kernel is
compiled with ``-fmad=false`` so the two agree on the card up to the
division and floor rounding they share.

Coverage is at least the tiled kernel's: no far block is dropped from a
crowded tile. ``march_samples`` counts the samples each ray executed; the
JAX kernel counts per-tile steps x 1024, so the two are not comparable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dynslam_tpu_torch.device import constant
from dynslam_tpu_torch.ops import cuda_build
from dynslam_tpu_torch.ops.tsdf import (
    SDF_SCALE, WEIGHT_SCALE, TsdfConfig, TsdfState, unpack_rgb,
)
from dynslam_tpu_torch.utils.se3 import inverse

_BIG = 1e9


class Raycast(NamedTuple):
    depth: torch.Tensor  # (H, W) f32 z-depth, 0 = miss
    points: torch.Tensor  # (H, W, 3) f32 world-frame hit points
    color: torch.Tensor  # (H, W, 3) uint8
    weight: torch.Tensor  # (H, W) f32 voxel weight at the hit
    hit: torch.Tensor  # (H, W) bool
    #: () int64: samples the rays executed in this render
    march_samples: torch.Tensor


class _March(NamedTuple):
    """The march's constants, shared by the kernel and ``raycast_ref``."""

    n_steps: int
    max_dda: int
    inv_voxel: float
    block: float
    dt: float
    t_min: float
    t_max: float
    t_cap: float


def _march_constants(cfg: TsdfConfig) -> _March:
    dt = 2.5 * cfg.voxel_size
    t_max = cfg.max_depth * 1.05
    return _March(
        # sphere steps + gap leaps need headroom beyond the XLA fine count
        # to reach far surfaces (grazing rays advance slowly)
        n_steps=max(cfg.raycast_fine_steps + 12, 8),
        # a DDA walk never needs more cells than the window's edge sum
        max_dda=sum(cfg.local_dims),
        inv_voxel=1.0 / cfg.voxel_size,
        block=cfg.block_size,
        dt=dt,
        t_min=cfg.min_depth * 0.6,
        t_max=t_max,
        t_cap=t_max + 2.0 * dt,
    )


def candidate_flags(
    cfg: TsdfConfig,
    state: TsdfState,
    slots: torch.Tensor,  # (V,) visible pool slots
    slots_mask: torch.Tensor,  # (V,) bool
    world_to_cam: torch.Tensor,  # (4, 4)
) -> torch.Tensor:
    """(P,) uint8: 1 for visible blocks that hold a stored negative voxel
    (a zero crossing needs one) and lie in depth range — the filter of
    ``pallas_raycast.build_candidates`` without the image tiles."""
    P = cfg.pool_capacity
    slots_c = torch.clamp(slots.to(torch.int64), 0, P - 1)
    rows = state.tsdf_w[slots_c]
    has_neg = (((rows & 0xFFFF) > 0) & ((rows >> 16) < 0)).any(dim=1)
    corner = constant(
        [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
        torch.float32, state.device,
    )
    pts = (state.block_coords[slots_c].to(torch.float32)[:, None, :]
           + corner[None]) * cfg.block_size  # (V, 8, 3)
    R, t = world_to_cam[:3, :3], world_to_cam[:3, 3]
    z = pts @ R[2] + t[2]
    ok = slots_mask & has_neg & (z.amax(1) > cfg.min_depth * 0.5) \
        & (z.amin(1) < cfg.max_depth * 1.05 + cfg.mu)
    flag = torch.zeros(P, dtype=torch.uint8, device=state.device)
    # masked-out entries rewrite the scratch row P-1, which stays 0
    flag[torch.where(ok, slots_c, P - 1)] = ok.to(torch.uint8)
    flag[-1:].zero_()
    return flag


def _ray_dirs(c2w: torch.Tensor, intr: torch.Tensor, h: int, w: int):
    """Per-pixel z-normalised world directions (dx, dy, dz), (H, W) each,
    in the kernel's operation order."""
    dev = c2w.device
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    rcx = (u - intr[2]) / intr[0]
    rcy = (v - intr[3]) / intr[1]
    return tuple(c2w[k, 0] * rcx + c2w[k, 1] * rcy + c2w[k, 2]
                 for k in range(3))


class _Scene:
    """Flat views of the map for the vectorised march of ``raycast_ref``:
    each method mirrors the device function of the same name in
    ``csrc/raycast.cu``."""

    def __init__(self, cfg, state, grid, origin, flag, c2w, intr, m: _March):
        self.cfg, self.m = cfg, m
        self.tsdf = state.tsdf_w.reshape(-1)
        self.color = state.color.reshape(-1)
        self.grid = grid
        self.flag = flag.to(torch.bool)
        self.origin = origin.to(torch.int32)
        h, w = cfg.height, cfg.width
        self.o = [c2w[k, 3].expand(h * w) for k in range(3)]
        self.d = [a.reshape(-1) for a in _ray_dirs(c2w, intr, h, w)]

    def rays(self, idx):
        return [a[idx] for a in self.o], [a[idx] for a in self.d]

    def voxel_at(self, o, d, t):
        return [torch.floor((o[k] + d[k] * t) * self.m.inv_voxel)
                .to(torch.int32) for k in range(3)]

    def cand_slot(self, c):
        """Candidate slot of block cells c = (cx, cy, cz), or -1."""
        dx, dy, dz = self.cfg.local_dims
        lx, ly, lz = (c[k] - self.origin[k] for k in range(3))
        inw = (lx >= 0) & (lx < dx) & (ly >= 0) & (ly < dy) \
            & (lz >= 0) & (lz < dz)
        lin = torch.where(inw, (lx * dy + ly) * dz + lz, 0).to(torch.int64)
        slot = torch.where(inw, self.grid[lin], -1)
        ok = (slot >= 0) & self.flag[torch.clamp(slot, min=0).to(torch.int64)]
        return torch.where(ok, slot, -1)

    def cand_voxel(self, o, d, t):
        """Flat pool index of the voxel at t in a candidate block, or -1."""
        v = self.voxel_at(o, d, t)
        slot = self.cand_slot([a >> 3 for a in v])
        vid = ((v[0] & 7) * 8 + (v[1] & 7)) * 8 + (v[2] & 7)
        ok = (t < self.m.t_max) & (slot >= 0)
        return torch.where(ok, slot.to(torch.int64) * 512 + vid, -1)

    def sample_sdf(self, o, d, t):
        idx = self.cand_voxel(o, d, t)
        v = self.tsdf[torch.clamp(idx, min=0)]
        obs = (idx >= 0) & ((v & 0xFFFF) > 0)
        return torch.where(obs, (v >> 16).to(torch.float32)
                           * (1.0 / SDF_SCALE), 1.0)

    def covered(self, o, d, t):
        v = self.voxel_at(o, d, t)
        return (t >= self.m.t_min) & (t <= self.m.t_max) \
            & (self.cand_slot([a >> 3 for a in v]) >= 0)

    def _steps(self, d):
        step, inv = [], []
        for k in range(3):
            s = torch.where(d[k].abs() < 1e-9, 0,
                            torch.where(d[k] > 0, 1, -1)).to(torch.int32)
            step.append(s)
            inv.append(torch.where(s != 0, 1.0 / d[k], 0.0))
        return step, inv

    def _exits(self, c, o, step, inv):
        """Per axis, the t at which the ray leaves cell c."""
        return [
            torch.where(
                step[k] != 0,
                ((c[k] + (step[k] > 0).to(torch.int32)).to(torch.float32)
                 * self.m.block - o[k]) * inv[k],
                float("inf"),
            )
            for k in range(3)
        ]

    def next_entry(self, o, d, t_a):
        """Entry t of the first candidate block after the cell holding
        t_a, or _BIG: a DDA over grid cells, at most max_dda cells, that
        gives up past t_cap."""
        m = self.m
        c = [a >> 3 for a in self.voxel_at(o, d, t_a)]
        step, inv = self._steps(d)
        out = torch.full_like(t_a, _BIG)
        live = torch.arange(t_a.shape[0], device=t_a.device)
        for _ in range(m.max_dda):
            if live.numel() == 0:
                break
            tb = self._exits(c, o, step, inv)
            a0 = (tb[0] <= tb[1]) & (tb[0] <= tb[2])
            a1 = ~a0 & (tb[1] <= tb[2])
            a2 = ~a0 & ~a1
            t_e = torch.where(a0, tb[0], torch.where(a1, tb[1], tb[2]))
            c = [c[0] + torch.where(a0, step[0], 0),
                 c[1] + torch.where(a1, step[1], 0),
                 c[2] + torch.where(a2, step[2], 0)]
            past = ~(t_e <= m.t_cap)
            found = ~past & (self.cand_slot(c) >= 0)
            out[live[found]] = t_e[found]
            keep = ~(past | found)
            live = live[keep]
            c, o, d, step, inv = ([a[keep] for a in x]
                                  for x in (c, o, d, step, inv))
        return out

    def sample_cw(self, o, d, t):
        """(weight bits, colour word, in-candidate) at t."""
        idx = self.cand_voxel(o, d, t)
        safe = torch.clamp(idx, min=0)
        ok = idx >= 0
        wb = torch.where(ok, self.tsdf[safe] & 0xFFFF, 0)
        col = torch.where(ok, self.color[safe], 0)
        return wb, col, ok


def _assemble(depth, color_bits, weight, samples, c2w, intr) -> Raycast:
    h, w = depth.shape
    hit = depth > 0.0
    d = _ray_dirs(c2w, intr, h, w)
    points = torch.stack([c2w[k, 3] + d[k] * depth for k in range(3)], -1)
    color = torch.where(hit[..., None], unpack_rgb(color_bits), 0)
    return Raycast(depth=depth, points=points, color=color.to(torch.uint8),
                   weight=weight, hit=hit,
                   march_samples=samples.sum(dtype=torch.int64))


def raycast_ref(
    cfg: TsdfConfig,
    state: TsdfState,
    grid: torch.Tensor,  # (n_cells,) int32 local index grid
    origin: torch.Tensor,  # (3,) int32
    flag: torch.Tensor,  # (P,) uint8 from candidate_flags
    cam_to_world: torch.Tensor,  # (4, 4) f32
    intrinsics: torch.Tensor,  # (4,) f32 fx, fy, cx, cy
) -> Raycast:
    """The kernel's rule in plain PyTorch, vectorised over pixels."""
    m = _march_constants(cfg)
    h, w = cfg.height, cfg.width
    sc = _Scene(cfg, state, grid, origin, flag, cam_to_world, intrinsics, m)
    n = h * w
    dev = state.device
    all_idx = torch.arange(n, device=dev)
    o, d = sc.rays(all_idx)
    t_min = torch.full((n,), m.t_min, dtype=torch.float32, device=dev)
    t0 = torch.where(sc.covered(o, d, t_min), t_min,
                     sc.next_entry(o, d, t_min))
    t = torch.clamp(t0, max=m.t_cap)
    psdf = torch.ones(n, dtype=torch.float32, device=dev)
    pt = t - m.dt
    bh = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    bc = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    ns = torch.zeros(n, dtype=torch.int32, device=dev)

    live = all_idx
    for _ in range(m.n_steps):
        run = t[live] < m.t_cap - 1e-3
        live = live[run]
        if live.numel() == 0:
            break
        o, d = sc.rays(live)
        tl = t[live]
        ns[live] += 1
        sdf = sc.sample_sdf(o, d, tl)
        prev_t = torch.maximum(pt[live], tl - 1.5 * m.dt)
        ps = psdf[live]
        cross = (ps > 0.0) & (sdf <= 0.0) & (tl < m.t_max) & (tl > 0.0)
        frac = ps / torch.clamp(ps - sdf, min=1e-6)
        bh[live[cross]] = (prev_t + (tl - prev_t) * frac)[cross]
        bc[live[cross]] = tl[cross]
        psdf[live] = sdf
        pt[live] = tl
        tn = tl + torch.clamp(sdf * (0.9 * cfg.mu), min=m.dt)
        cov = sc.covered(o, d, tn)
        t_nxt = tn.clone()
        gap = ~cov
        if gap.any():
            og, dg = [a[gap] for a in o], [a[gap] for a in d]
            e = sc.next_entry(og, dg, tl[gap] + 0.25 * m.dt)
            t_nxt[gap] = torch.maximum(e - 0.25 * m.dt, tl[gap] + 0.5 * m.dt)
        t[live] = torch.clamp(t_nxt, max=m.t_cap)
        live = live[~cross]

    o, d = sc.rays(all_idx)
    found = bh < m.t_max
    bh = torch.where(found, bh, 0.0)
    bc = torch.where(found, bc, 0.0)
    sh = sc.sample_sdf(o, d, bh)
    clip = 2.5 * cfg.voxel_size
    bh = torch.where(found & (sh.abs() < 0.5),
                     bh + torch.clamp(sh * cfg.mu, -clip, clip), bh)
    wb, col, in_hit = sc.sample_cw(o, d, bh)
    wb1, col1, _ = sc.sample_cw(o, d, bc)
    wb2, col2, _ = sc.sample_cw(o, d, bc - m.dt)
    ok_hit = in_hit & (wb > 0)
    ok_fb = wb1 > 0
    wb = torch.where(ok_hit, wb, torch.where(ok_fb, wb1, wb2))
    col = torch.where(ok_hit, col, torch.where(ok_fb, col1, col2))

    depth = torch.where(found, bh, 0.0).reshape(h, w)
    color_bits = torch.where(found, col, 0).reshape(h, w)
    weight = torch.where(found, wb.to(torch.float32) * (1.0 / WEIGHT_SCALE),
                         0.0).reshape(h, w)
    return _assemble(depth, color_bits, weight, ns.reshape(h, w),
                     cam_to_world, intrinsics)


def _raycast_cuda(cfg, state, grid, origin, flag, cam_to_world,
                  intrinsics) -> Raycast:
    dev = state.device
    for name, t in (("grid", grid), ("origin", origin), ("flag", flag),
                    ("cam_to_world", cam_to_world),
                    ("intrinsics", intrinsics)):
        if t.device != dev:
            raise ValueError(f"raycast: {name} on {t.device}, pool on {dev}")
    dx, dy, dz = cfg.local_dims
    if grid.shape != (dx * dy * dz,) or grid.dtype != torch.int32:
        raise ValueError("raycast: grid must be int32 (n_cells,)")
    if flag.shape != (cfg.pool_capacity,) or flag.dtype != torch.uint8:
        raise ValueError("raycast: flag must be uint8 (P,)")
    for name in ("tsdf_w", "color"):
        t = getattr(state, name)
        if t.shape != (cfg.pool_capacity, 512) or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"raycast: {name} must be contiguous int32 "
                             f"(P, 512)")
    if cam_to_world.shape != (4, 4) or intrinsics.shape != (4,) \
            or origin.shape != (3,):
        raise ValueError("raycast: cam_to_world must be (4, 4), intrinsics "
                         "(4,), origin (3,)")
    m = _march_constants(cfg)
    h, w = cfg.height, cfg.width
    c2w = cam_to_world.to(torch.float32).contiguous()
    intr = intrinsics.to(torch.float32).contiguous()
    org = origin.to(torch.int32).contiguous()
    grid_c = grid.contiguous()
    depth = torch.empty(h, w, dtype=torch.float32, device=dev)
    color_bits = torch.empty(h, w, dtype=torch.int32, device=dev)
    weight = torch.empty(h, w, dtype=torch.float32, device=dev)
    samples = torch.empty(h, w, dtype=torch.int32, device=dev)
    fn = cuda_build.function("raycast", "dynslam_raycast",
                             "ppppppp iiiiiii ffffffffffffff pppp p")
    err = fn(
        state.tsdf_w.data_ptr(), state.color.data_ptr(), grid_c.data_ptr(),
        flag.data_ptr(), c2w.data_ptr(), intr.data_ptr(), org.data_ptr(),
        dx, dy, dz, h, w, m.n_steps, m.max_dda,
        m.inv_voxel, m.block, 1.0 / SDF_SCALE, m.dt, 1.5 * m.dt,
        0.25 * m.dt, 0.5 * m.dt, cfg.mu, 0.9 * cfg.mu,
        2.5 * cfg.voxel_size, m.t_min, m.t_max, m.t_cap, m.t_cap - 1e-3,
        depth.data_ptr(), color_bits.data_ptr(), weight.data_ptr(),
        samples.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check_launch(err, "raycast")
    raycast.launches += 1
    return _assemble(depth, color_bits, weight, samples, c2w, intr)


def raycast(
    cfg: TsdfConfig,
    state: TsdfState,
    grid: torch.Tensor,
    origin: torch.Tensor,
    slots: torch.Tensor,
    slots_mask: torch.Tensor,
    cam_to_world: torch.Tensor,
    intrinsics: Optional[torch.Tensor] = None,
) -> Raycast:
    """Render the map from ``cam_to_world`` at the configured frame size.
    CPU pool: ``raycast_ref``; CUDA pool: the kernel
    (``raycast.launches`` counts its launches)."""
    if intrinsics is None:
        intrinsics = constant((cfg.fx, cfg.fy, cfg.cx, cfg.cy),
                              torch.float32, state.device)
    flag = candidate_flags(cfg, state, slots, slots_mask,
                           inverse(cam_to_world))
    dev = state.device
    if dev.type == "cpu":
        return raycast_ref(cfg, state, grid, origin, flag, cam_to_world,
                           intrinsics)
    if dev.type == "cuda":
        return _raycast_cuda(cfg, state, grid, origin, flag, cam_to_world,
                             intrinsics)
    raise ValueError(f"raycast: unsupported device {dev}")


raycast.launches = 0
