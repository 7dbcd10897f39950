"""The raycast's candidate bitmap: ``candidate_bits_ref`` (the plain twin
of the pre-pass kernel in ``csrc/raycast.cu``) against the per-slot rule
of ``candidate_flags``, and ``raycast_ref`` driven through the bitmap's
cell test against the march through the per-slot flags, on the maps of
tests/test_pallas_raycast.py and over a sweep of camera poses."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.ops import raycast as tr
from dynslam_tpu_torch.ops import tsdf as tt
from dynslam_tpu_torch.utils import se3

from test_pallas_raycast import _cfg, _fuse_frames
from torch_threads import threads

torch_threads = threads(2)


def _dense_map(cfg):
    """test_torch_raycast's ground rising to a far wall, fused twice."""
    h, w = cfg.height, cfg.width
    vv, _ = np.mgrid[0:h, 0:w].astype(np.float32)
    with np.errstate(divide="ignore"):
        depth = jnp.asarray(np.clip(
            np.where(vv > h * 0.5, 180.0 / (vv - h * 0.5 + 10.0), 18.0),
            1.5, 18.0).astype(np.float32))
    eye = jnp.eye(4, dtype=jnp.float32)
    rgb = jnp.asarray(np.full((h, w, 3), 128), jnp.uint8)
    state = jt.create_state(cfg)
    for t in range(2):
        origin = jt.compute_origin(cfg, eye)
        grid = jt.build_local_grid(cfg, state, origin)
        state, grid, _ = jt.allocate(cfg, state, grid, origin, depth, eye,
                                     jnp.int32(t))
        slots, mask = jt.visible_blocks(cfg, state, grid, origin, eye)
        state = jt.integrate(cfg, state, slots, mask, rgb, depth, eye,
                             jnp.int32(t))
    return state


@functools.cache
def _port_map(name):
    """(port config, port state) of one of the JAX test maps."""
    if name == "wavy":
        cfg_j = _cfg()
        state_j = _fuse_frames(cfg_j)[0]
    else:
        cfg_j = _cfg(width=256, height=96, cx=128.0, cy=48.0,
                     local_dims=(64, 24, 64), max_depth=20.0)
        state_j = _dense_map(cfg_j)
    cfg = convert.tsdf_config_from_jax(cfg_j)
    state = convert.tsdf_state_from_numpy(
        {k: np.asarray(getattr(state_j, k)) for k in convert.STATE_KEYS},
        "cpu")
    return cfg, state


def _view(cfg, state, c2w):
    """(grid, origin, slots, mask) of the local window seen from c2w."""
    origin = tt.compute_origin(cfg, c2w)
    grid = tt.build_local_grid(cfg, state, origin)
    slots, mask = tt.visible_blocks(cfg, state, grid, origin,
                                    se3.inverse(c2w))
    return grid, origin, slots, mask


def _flag_cells(cfg, state, grid, slots, mask, c2w):
    """(n_cells,) bool of the per-slot rule: ``(grid >= 0) & flag[grid]``."""
    flag = tr.candidate_flags(cfg, state, slots, mask, c2w)
    return (grid >= 0) & (flag[grid.clamp(min=0).long()] > 0)


def _assert_bits_match(cfg, state, c2w):
    grid, origin, slots, mask = _view(cfg, state, c2w)
    bits = tr.candidate_bits_ref(cfg, state, grid, origin, slots, mask, c2w)
    assert bits.dtype == torch.int32
    assert bits.shape == (tr.bitmap_words(cfg),)
    nf = tr.fine_words(cfg)
    assert nf % 4 == 0 and tr.bitmap_words(cfg) % 4 == 0  # 16-byte vectors
    cells = tr.unpack_bits(bits[:nf], nf * 32)
    want = _flag_cells(cfg, state, grid, slots, mask, c2w)
    assert torch.equal(cells[:cfg.n_cells], want)
    assert not cells[cfg.n_cells:].any()  # the padding stays clear
    # the coarse level: one bit per super-cell holding a candidate cell
    cdims = tr.coarse_dims(cfg)
    n_sup = cdims[0] * cdims[1] * cdims[2]
    coarse = tr.unpack_bits(bits[nf:], (bits.shape[0] - nf) * 32)
    dx, dy, dz = cfg.local_dims
    sup = want.view(dx, dy, dz).nonzero() // tr.SUPER
    want_coarse = torch.zeros(cdims, dtype=torch.bool)
    want_coarse[sup[:, 0], sup[:, 1], sup[:, 2]] = True
    assert torch.equal(coarse[:n_sup].view(cdims), want_coarse)
    assert not coarse[n_sup:].any()
    # the CPU dispatch is the plain version
    before = tr.candidate_bits.launches
    assert torch.equal(tr.candidate_bits(cfg, state, grid, origin, slots,
                                         mask, c2w), bits)
    assert tr.candidate_bits.launches == before
    return int(want.sum())


@pytest.mark.parametrize("name", ["wavy", "dense"])
def test_candidate_bits_ref_equals_flag_rule(name):
    cfg, state = _port_map(name)
    assert _assert_bits_match(cfg, state, torch.eye(4)) > 50


_POSE = st.tuples(
    st.floats(-0.4, 0.4), st.floats(-0.2, 0.2),  # yaw, pitch (rad)
    st.floats(-1.5, 1.5), st.floats(-0.5, 0.5), st.floats(-2.0, 3.0))


def _pose(yaw, pitch, tx, ty, tz):
    return se3.twist_to_transform(torch.tensor(
        [pitch, yaw, 0.0, tx, ty, tz], dtype=torch.float32))


@settings(max_examples=30, deadline=None)
@given(_POSE)
def test_candidate_bits_ref_over_poses(pose):
    cfg, state = _port_map("wavy")
    _assert_bits_match(cfg, state, _pose(*pose))


class _FlagScene(tr._Scene):
    """The march's scene with the per-slot flags' cell test (the grid
    first, then the slot's flag) and the fine DDA walk everywhere (every
    super-cell counts as occupied, so none is skipped)."""

    def __init__(self, cfg, state, grid, origin, flag, c2w, intr):
        super().__init__(cfg, state, grid, origin, None,
                         torch.ones(tr.coarse_dims(cfg), dtype=torch.bool),
                         c2w, intr, tr._march_constants(cfg))
        self.flag = flag.to(torch.bool)

    def cand_slot(self, c):
        dx, dy, dz = self.cfg.local_dims
        lx, ly, lz = (c[k] - self.origin[k] for k in range(3))
        inw = (lx >= 0) & (lx < dx) & (ly >= 0) & (ly < dy) \
            & (lz >= 0) & (lz < dz)
        lin = torch.where(inw, (lx * dy + ly) * dz + lz, 0).to(torch.int64)
        slot = torch.where(inw, self.grid[lin], -1)
        ok = (slot >= 0) & self.flag[torch.clamp(slot, min=0).to(torch.int64)]
        return torch.where(ok, slot, -1)


@pytest.mark.parametrize("name,pose", [
    ("wavy", (0.0, 0.0, 0.0, 0.0, 0.0)),
    ("wavy", (0.15, -0.05, 0.4, 0.1, 0.6)),
    ("dense", (0.0, 0.0, 0.0, 0.0, 0.0)),
])
def test_raycast_ref_bitmap_equals_flag_march(name, pose):
    cfg, state = _port_map(name)
    c2w = _pose(*pose)
    intr = torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy])
    grid, origin, slots, mask = _view(cfg, state, c2w)
    bits = tr.candidate_bits_ref(cfg, state, grid, origin, slots, mask, c2w)
    got = tr.raycast_ref(cfg, state, grid, origin, bits, c2w, intr)
    flag = tr.candidate_flags(cfg, state, slots, mask, c2w)
    want = tr._march_ref(cfg, _FlagScene(cfg, state, grid, origin, flag,
                                         c2w, intr), c2w, intr)
    for field in tr.Raycast._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert got.hit.float().mean() > 0.3
    # the public entry takes the same path on the CPU
    rc = tr.raycast(cfg, state, grid, origin, slots, mask, c2w, intr)
    for field in tr.Raycast._fields:
        assert torch.equal(getattr(rc, field), getattr(got, field)), field


@pytest.mark.parametrize("n_cells", [1, 31, 32, 33, 127, 128, 129, 1000])
def test_pack_unpack_bits_roundtrip(n_cells):
    rng = np.random.default_rng(n_cells)
    cells = torch.from_numpy(rng.random(n_cells) < 0.4)
    cells[-1] = True  # a set last bit: bit 31 of a word is its sign
    words = -(-n_cells // 128) * 4
    bits = tr.pack_bits(cells, words)
    assert bits.dtype == torch.int32 and bits.shape == (words,)
    assert torch.equal(tr.unpack_bits(bits, n_cells), cells)
    assert sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in bits) \
        == int(cells.sum())


@pytest.mark.parametrize("dims,fits", [
    ((160, 48, 160), True),  # the bench's static window, 150 KB
    ((64, 24, 80), True),  # the object volumes' window, 15 KB
    ((192, 64, 160), False),  # 240 KB: over one CTA's shared memory
])
def test_check_window_shared_memory_budget(dims, fits):
    cfg = tt.TsdfConfig(local_dims=dims)
    if fits:
        tr.check_window(cfg)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            tr.check_window(cfg)


def _full_walk(sc, o, d, t_a):
    """``next_entry`` without the window early-out: the DDA walks until it
    finds a candidate, passes t_cap or has taken max_dda cells."""
    m = sc.m
    c = [a >> 3 for a in sc.voxel_at(o, d, t_a)]
    step, inv = sc._steps(d)
    out = torch.full_like(t_a, tr._BIG)
    live = torch.arange(t_a.shape[0])
    for _ in range(m.max_dda):
        if live.numel() == 0:
            break
        tb = sc._exits(c, o, step, inv)
        a0 = (tb[0] <= tb[1]) & (tb[0] <= tb[2])
        a1 = ~a0 & (tb[1] <= tb[2])
        a2 = ~a0 & ~a1
        t_e = torch.where(a0, tb[0], torch.where(a1, tb[1], tb[2]))
        c = [c[0] + torch.where(a0, step[0], 0),
             c[1] + torch.where(a1, step[1], 0),
             c[2] + torch.where(a2, step[2], 0)]
        past = ~(t_e <= m.t_cap)
        found = ~past & (sc.cand_slot(c) >= 0)
        out[live[found]] = t_e[found]
        keep = ~(past | found)
        live = live[keep]
        c, o, d, step, inv = ([a[keep] for a in x]
                              for x in (c, o, d, step, inv))
    return out


def _random_rays(n, block, rng):
    """n rays from inside and around a window, with axis-aligned rays and
    rays from block corners along diagonals (exit ties) among them."""
    o = rng.uniform([-10.0, -5.0, -6.0], [10.0, 5.0, 14.0], (n, 3))
    d = rng.normal(size=(n, 3))
    k = n // 10
    d[:k, rng.integers(0, 3, k)] = 0.0  # one zero component
    for i in range(k, 2 * k):  # axis-aligned
        axis = rng.integers(0, 3)
        d[i] = 0.0
        d[i, axis] = rng.choice([-1.0, 1.0])
    corners = slice(2 * k, 4 * k)
    o[corners] = np.round(o[corners] / block) * block  # block corners
    d[corners] = rng.choice([-1.0, 1.0], (2 * k, 3)) \
        * rng.choice([1.0, 2.0], (2 * k, 1))
    t_a = rng.uniform(0.0, 6.0, n)
    o, d = o.astype(np.float32), d.astype(np.float32)
    return ([torch.from_numpy(o[:, i].copy()) for i in range(3)],
            [torch.from_numpy(d[:, i].copy()) for i in range(3)],
            torch.from_numpy(t_a.astype(np.float32)))


@pytest.mark.parametrize("density", [0.0, 0.02, 0.2])
def test_next_entry_window_exit_matches_full_walk(density):
    """The DDA's early stop once a ray has left the window for good gives
    the full walk's entry t bit for bit, over 12,000 random rays."""
    cfg = tt.TsdfConfig(pool_capacity=1024, local_dims=(12, 6, 10),
                        voxel_size=0.1, max_depth=12.0, width=4, height=2)
    rng = np.random.default_rng(int(density * 100) + 3)
    cand = torch.from_numpy(rng.random(cfg.n_cells) < density)
    grid = torch.arange(cfg.n_cells, dtype=torch.int32)
    origin = torch.tensor([-6, -3, -2], dtype=torch.int32)
    state = tt.create_state(cfg, "cpu")
    sc = tr._Scene(cfg, state, grid, origin, cand,
                   tr.coarse_cells(cfg, cand), torch.eye(4),
                   torch.tensor([1.0, 1.0, 2.0, 1.0]),
                   tr._march_constants(cfg))
    o, d, t_a = _random_rays(12000, cfg.block_size, rng)
    got = sc.next_entry(o, d, t_a)
    want = _full_walk(sc, o, d, t_a)
    assert torch.equal(got, want)
    found = want < tr._BIG
    if density > 0:
        assert 0.01 < found.float().mean() < 0.95
    else:
        assert not found.any()
