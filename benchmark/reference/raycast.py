"""Full-frame TSDF raycast in plain PyTorch: a frozen copy of the port's
``candidate_bits_ref`` and ``raycast_ref`` (the rules its CUDA pre-pass
and march in ``csrc/raycast.cu`` are held to bit for bit), with
``raycast`` running the two on any device."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference._util import constant
from benchmark.reference.tsdf import (
    SDF_SCALE, WEIGHT_SCALE, Raycast, TsdfConfig, TsdfState, grid_linear,
    unpack_rgb,
)

_BIG = 1e9
#: local-grid cells per super-cell edge of the DDA's coarse level
SUPER = 4
#: shared memory one CTA may opt in to on sm_90 (227 KB), less a reserve
#: for the march kernel's own static shared memory
SMEM_OPTIN_BYTES = 232448
_SMEM_RESERVE = 1024


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


def _vec_words(n_bits: int) -> int:
    """int32 words holding n_bits, padded to whole 16-byte vectors."""
    return -(-n_bits // 128) * 4


def fine_words(cfg: TsdfConfig) -> int:
    """Words of the fine part of the bitmap: one bit per local-grid cell."""
    return _vec_words(cfg.n_cells)


def bitmap_words(cfg: TsdfConfig) -> int:
    """int32 words of the candidate bitmap: the fine bits (``fine_words``),
    then one bit per super-cell of the DDA's coarse level."""
    cx, cy, cz = coarse_dims(cfg)
    return fine_words(cfg) + _vec_words(cx * cy * cz)


def coarse_dims(cfg: TsdfConfig):
    """Super-cells of SUPER^3 local-grid cells covering the window."""
    return tuple(-(-d // SUPER) for d in cfg.local_dims)


def coarse_cells(cfg: TsdfConfig, cand: torch.Tensor) -> torch.Tensor:
    """(cx, cy, cz) bool: super-cells holding a candidate cell."""
    dims, cdims = cfg.local_dims, coarse_dims(cfg)
    full = torch.zeros(*(c * SUPER for c in cdims), dtype=torch.bool,
                       device=cand.device)
    full[:dims[0], :dims[1], :dims[2]] = cand[:cfg.n_cells].view(dims)
    return full.view(cdims[0], SUPER, cdims[1], SUPER, cdims[2], SUPER) \
        .any(5).any(3).any(1)


def _depth_range(cfg: TsdfConfig):
    """A candidate block's corner depths must reach above the first and
    below the second."""
    return cfg.min_depth * 0.5, cfg.max_depth * 1.05 + cfg.mu


def _z_row(c2w: torch.Tensor):
    """Row 2 of the rigid inverse (R^T, -R^T t) of ``c2w``: the camera z
    of a world point is p . r + t, in the pre-pass kernel's order."""
    r = (c2w[0, 2], c2w[1, 2], c2w[2, 2])
    t = -(c2w[0, 2] * c2w[0, 3] + c2w[1, 2] * c2w[1, 3]
          + c2w[2, 2] * c2w[2, 3])
    return r, t


def candidate_flags(
    cfg: TsdfConfig,
    state: TsdfState,
    slots: torch.Tensor,  # (V,) visible pool slots
    slots_mask: torch.Tensor,  # (V,) bool
    cam_to_world: torch.Tensor,  # (4, 4)
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
    r, t = _z_row(cam_to_world)
    z = pts[..., 0] * r[0] + pts[..., 1] * r[1] + pts[..., 2] * r[2] + t
    z_lo, z_hi = _depth_range(cfg)
    ok = slots_mask & has_neg & (z.amax(1) > z_lo) & (z.amin(1) < z_hi)
    flag = torch.zeros(P, dtype=torch.uint8, device=state.device)
    # masked-out entries rewrite the scratch row P-1, which stays 0
    flag[torch.where(ok, slots_c, P - 1)] = ok.to(torch.uint8)
    flag[-1:].zero_()
    return flag


def pack_bits(cells: torch.Tensor, n_words: int) -> torch.Tensor:
    """(n_cells,) bool -> (n_words,) int32, cell c at bit c % 32 of word
    c // 32."""
    flat = torch.zeros(n_words * 32, dtype=torch.int64, device=cells.device)
    flat[:cells.numel()] = cells.to(torch.int64)
    weights = torch.arange(32, device=cells.device)
    words = (flat.view(n_words, 32) << weights).sum(1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(bits: torch.Tensor, n_cells: int) -> torch.Tensor:
    """(n_words,) int32 -> (n_cells,) bool; the inverse of ``pack_bits``."""
    shifts = torch.arange(32, device=bits.device)
    return (((bits.to(torch.int64)[:, None] >> shifts) & 1) > 0) \
        .reshape(-1)[:n_cells]


def candidate_bits_ref(
    cfg: TsdfConfig,
    state: TsdfState,
    grid: torch.Tensor,  # (n_cells,) int32 local index grid
    origin: torch.Tensor,  # (3,) int32
    slots: torch.Tensor,  # (V,) visible pool slots
    slots_mask: torch.Tensor,  # (V,) bool
    cam_to_world: torch.Tensor,  # (4, 4)
) -> torch.Tensor:
    """The pre-pass kernel's rule in plain PyTorch: (``bitmap_words``,)
    int32, the bit of a local-grid cell set where the cell holds a slot
    that ``candidate_flags`` flags (the visible block's own cell, where
    ``grid`` holds it)."""
    P = cfg.pool_capacity
    flag = candidate_flags(cfg, state, slots, slots_mask, cam_to_world)
    slots_c = torch.clamp(slots.to(torch.int64), 0, P - 1)
    lin, in_win = grid_linear(
        cfg, state.block_coords[slots_c] - origin.to(torch.int32)[None, :])
    lin = torch.where(in_win, lin, 0).to(torch.int64)
    ok = slots_mask & (flag[slots_c] > 0) & in_win & (grid[lin] == slots_c)
    cells = torch.zeros(cfg.n_cells + 1, dtype=torch.bool,
                        device=state.device)
    # entries that are not ok write the dump cell n_cells
    cells.index_fill_(0, torch.where(ok, lin, cfg.n_cells), True)
    cand = cells[:cfg.n_cells]
    return torch.cat([
        pack_bits(cand, fine_words(cfg)),
        pack_bits(coarse_cells(cfg, cand).reshape(-1),
                  bitmap_words(cfg) - fine_words(cfg))])


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
    ``csrc/raycast.cu``. ``cand`` (n_cells,) bool is the unpacked
    candidate bitmap and ``coarse`` (``coarse_dims``) bool its
    super-cells."""

    def __init__(self, cfg, state, grid, origin, cand, coarse, c2w, intr,
                 m: _March):
        self.cfg, self.m = cfg, m
        self.tsdf = state.tsdf_w.reshape(-1)
        self.color = state.color.reshape(-1)
        self.grid = grid
        self.cand = cand
        self.coarse = coarse
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
        """Candidate slot of block cells c = (cx, cy, cz), or -1: a bit
        test, then the grid only for a candidate cell."""
        dx, dy, dz = self.cfg.local_dims
        lx, ly, lz = (c[k] - self.origin[k] for k in range(3))
        inw = (lx >= 0) & (lx < dx) & (ly >= 0) & (ly < dy) \
            & (lz >= 0) & (lz < dz)
        lin = torch.where(inw, (lx * dy + ly) * dz + lz, 0).to(torch.int64)
        ok = inw & self.cand[lin]
        return torch.where(ok, self.grid[lin], -1)

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
        return [self._exit_at(k, c[k], o, step, inv) for k in range(3)]

    def leaving(self, c, step):
        """Outside the window on an axis and not moving back into it: a
        line that has left the (convex) window never re-enters it, so the
        walk can find no candidate any more."""
        out = torch.zeros_like(c[0], dtype=torch.bool)
        for k, n in enumerate(self.cfg.local_dims):
            lk = c[k] - self.origin[k]
            out |= ((lk < 0) & (step[k] <= 0)) | ((lk >= n) & (step[k] >= 0))
        return out

    def _exit_at(self, k, c, o, step, inv):
        """The t at which the ray leaves cell index c along axis k."""
        return torch.where(
            step[k] != 0,
            ((c + (step[k] > 0).to(torch.int32)).to(torch.float32)
             * self.m.block - o[k]) * inv[k],
            float("inf"))

    def _skip(self, c, o, step, inv):
        """The fine walk's run through the empty super-cell holding cell c
        (in the window), done at once: (steps along each axis, t of the
        step that leaves the super-cell). The walk merges the three axes'
        exit sequences, each non-decreasing, in (t, axis) order, so the
        step that leaves is the least (t, axis) of the three boundary
        exits, and along each other axis the walk steps exactly over the
        prefix of exits that come before it in that order."""
        dims = self.cfg.local_dims
        last, bound = [], []
        for k in range(3):
            lk = c[k] - self.origin[k]
            lo = torch.div(lk, SUPER, rounding_mode="floor") * SUPER
            b = torch.where(step[k] > 0,
                            torch.clamp(lo + SUPER - 1, max=dims[k] - 1), lo)
            last.append(b)
            bound.append(self._exit_at(k, b + self.origin[k], o, step, inv))
        a0 = (bound[0] <= bound[1]) & (bound[0] <= bound[2])
        a1 = ~a0 & (bound[1] <= bound[2])
        axis = torch.where(a0, 0, torch.where(a1, 1, 2))
        t_x = torch.where(a0, bound[0], torch.where(a1, bound[1], bound[2]))
        n = []
        for k in range(3):
            limit = (last[k] - (c[k] - self.origin[k])).abs()
            cnt = torch.zeros_like(limit)
            alive = torch.ones_like(limit, dtype=torch.bool)
            for i in range(SUPER):
                v = self._exit_at(k, c[k] + i * step[k], o, step, inv)
                alive &= (i < limit) & ((v < t_x) | ((v == t_x) & (k < axis)))
                cnt += alive.to(cnt.dtype)
            n.append(torch.where(axis == k, limit + 1, cnt))
        return n, t_x

    def next_entry(self, o, d, t_a):
        """Entry t of the first candidate block after the cell holding
        t_a, or _BIG: a DDA over grid cells, at most max_dda cells, that
        gives up past t_cap, or once the ray has left the window for good
        (where the full walk would find nothing either). In a super-cell
        with no candidate the walk's run to its exit is taken in one go
        (``_skip``); its cells count toward max_dda."""
        m = self.m
        dims = self.cfg.local_dims
        c = [a >> 3 for a in self.voxel_at(o, d, t_a)]
        step, inv = self._steps(d)
        out = torch.full_like(t_a, _BIG)
        it = torch.zeros_like(c[0])
        live = torch.arange(t_a.shape[0], device=t_a.device)
        while live.numel():
            loc = [c[k] - self.origin[k] for k in range(3)]
            inw = (loc[0] >= 0) & (loc[0] < dims[0]) & (loc[1] >= 0) \
                & (loc[1] < dims[1]) & (loc[2] >= 0) & (loc[2] < dims[2])
            sup = [torch.div(torch.clamp(loc[k], 0, dims[k] - 1), SUPER,
                             rounding_mode="floor") for k in range(3)]
            empty = inw & ~self.coarse[sup[0], sup[1], sup[2]]
            # one fine step
            tb = self._exits(c, o, step, inv)
            a0 = (tb[0] <= tb[1]) & (tb[0] <= tb[2])
            a1 = ~a0 & (tb[1] <= tb[2])
            t_e = torch.where(a0, tb[0], torch.where(a1, tb[1], tb[2]))
            n = [a0.to(c[0].dtype), a1.to(c[0].dtype),
                 (~a0 & ~a1).to(c[0].dtype)]
            if empty.any():
                n_s, t_s = self._skip(c, o, step, inv)
                n = [torch.where(empty, n_s[k], n[k]) for k in range(3)]
                t_e = torch.where(empty, t_s, t_e)
            it = it + n[0] + n[1] + n[2]
            c = [c[k] + n[k] * step[k] for k in range(3)]
            stop = ~(t_e <= m.t_cap) | (it > m.max_dda)
            found = ~stop & (self.cand_slot(c) >= 0)
            out[live[found]] = t_e[found]
            keep = ~(stop | found | self.leaving(c, step)) & (it < m.max_dda)
            live = live[keep]
            c, o, d, step, inv, it = ([a[keep] for a in x] if isinstance(
                x, list) else x[keep] for x in (c, o, d, step, inv, it))
        return out

    def sample_cw(self, o, d, t):
        """(weight bits, colour word, in-candidate) at t."""
        idx = self.cand_voxel(o, d, t)
        safe = torch.clamp(idx, min=0)
        ok = idx >= 0
        wb = torch.where(ok, self.tsdf[safe] & 0xFFFF, 0)
        col = torch.where(ok, self.color[safe], 0)
        return wb, col, ok


def _march_ref(cfg: TsdfConfig, sc: _Scene, c2w: torch.Tensor,
               intr: torch.Tensor) -> Raycast:
    """The march of ``raycast_ref`` over the scene ``sc``."""
    m = sc.m
    h, w = cfg.height, cfg.width
    n = h * w
    dev = c2w.device
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
    weight = torch.where(found, wb.to(torch.float32) * (1.0 / WEIGHT_SCALE),
                         0.0).reshape(h, w)
    hit = depth > 0.0
    dirs = _ray_dirs(c2w, intr, h, w)
    points = torch.stack([c2w[k, 3] + dirs[k] * depth for k in range(3)], -1)
    color = torch.where(hit[..., None], unpack_rgb(col.reshape(h, w)), 0)
    return Raycast(depth=depth, points=points, color=color.to(torch.uint8),
                   weight=weight, hit=hit,
                   march_samples=ns.sum(dtype=torch.int64))


def raycast_ref(
    cfg: TsdfConfig,
    state: TsdfState,
    grid: torch.Tensor,  # (n_cells,) int32 local index grid
    origin: torch.Tensor,  # (3,) int32
    bits: torch.Tensor,  # (bitmap_words,) int32 from candidate_bits_ref
    cam_to_world: torch.Tensor,  # (4, 4) f32
    intrinsics: torch.Tensor,  # (4,) f32 fx, fy, cx, cy
) -> Raycast:
    """The march kernel's rule in plain PyTorch, vectorised over pixels."""
    cdims = coarse_dims(cfg)
    coarse = unpack_bits(bits[fine_words(cfg):],
                         cdims[0] * cdims[1] * cdims[2]).view(cdims)
    sc = _Scene(cfg, state, grid, origin, unpack_bits(bits, cfg.n_cells),
                coarse, cam_to_world, intrinsics, _march_constants(cfg))
    return _march_ref(cfg, sc, cam_to_world, intrinsics)


def raycast(cfg, state, grid, origin, slots, slots_mask, cam_to_world,
            intrinsics=None) -> Raycast:
    """Render the map from ``cam_to_world`` at the configured frame size."""
    if intrinsics is None:
        intrinsics = constant((cfg.fx, cfg.fy, cfg.cx, cfg.cy),
                              torch.float32, state.device)
    bits = candidate_bits_ref(cfg, state, grid, origin, slots, slots_mask,
                              cam_to_world)
    return raycast_ref(cfg, state, grid, origin, bits, cam_to_world,
                       intrinsics)
