"""Raycast: the port's plain version ``raycast_ref`` (the rule of the CUDA
kernel ``csrc/raycast.cu``) against the JAX package's tiled Pallas
raycaster run in interpret mode, on the maps of
tests/test_pallas_raycast.py. The two place samples differently (dense
grid lookups vs per-tile candidate lists), so parity is statistical."""

import jax.numpy as jnp
import numpy as np
import torch

from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu.ops.pallas_raycast import raycast_tiled
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.ops import raycast as tr
from dynslam_tpu_torch.ops import tsdf as tt

from test_pallas_raycast import _cfg, _fuse_frames
from torch_threads import threads

torch_threads = threads(2)


def _port_raycast(cfg_j, state_j, origin, slots, mask, c2w):
    cfg = convert.tsdf_config_from_jax(cfg_j)
    state = convert.tsdf_state_from_numpy(
        {k: np.asarray(getattr(state_j, k)) for k in convert.STATE_KEYS},
        "cpu")
    o = torch.tensor(np.asarray(origin))
    grid = tt.build_local_grid(cfg, state, o)
    intr = torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy])
    before = tr.raycast.launches
    rc = tr.raycast(cfg, state, grid, o, torch.tensor(np.asarray(slots)),
                    torch.tensor(np.asarray(mask)),
                    torch.tensor(np.asarray(c2w)), intr)
    assert tr.raycast.launches == before  # CPU: the plain version
    return rc


def test_raycast_ref_matches_tiled():
    cfg = _cfg()
    state, grid, origin, slots, mask, eye, depth_in = _fuse_frames(cfg)
    intr = jnp.asarray([cfg.fx, cfg.fy, cfg.cx, cfg.cy], jnp.float32)
    ref = raycast_tiled(cfg, state, slots, mask, origin, eye, intr,
                        interpret=True)
    got = _port_raycast(cfg, state, origin, slots, mask, eye)

    ref_hit = np.asarray(ref.hit)
    got_hit = got.hit.numpy()
    assert ref_hit.mean() > 0.5
    assert got_hit[ref_hit].mean() >= 0.98
    both = ref_hit & got_hit
    dd = np.abs(np.asarray(ref.depth)[both] - got.depth.numpy()[both])
    assert np.median(dd) < cfg.voxel_size
    assert np.percentile(dd, 95) < 3 * cfg.voxel_size
    assert (got.weight.numpy()[both] > 0).mean() >= 0.99
    c_ref = np.asarray(ref.color)[both].astype(np.int32)
    c_got = got.color.numpy()[both].astype(np.int32)
    assert (np.abs(c_ref - c_got).max(-1) <= 8).mean() >= 0.9
    # world points sit on the rays at the hit depth
    pts = got.points.numpy()[both]
    assert np.allclose(pts[:, 2], got.depth.numpy()[both], atol=1e-4)
    assert int(got.march_samples) > 0


def test_raycast_ref_reach_on_dense_map():
    """Ground rising to a far wall: the port covers the fused surface at
    least as well as the tiled kernel (which drops far blocks from
    crowded tiles), less one point."""
    cfg = _cfg(width=256, height=96, cx=128.0, cy=48.0,
               local_dims=(64, 24, 64), max_depth=20.0)
    h, w = cfg.height, cfg.width
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    with np.errstate(divide="ignore"):
        depth_np = np.clip(
            np.where(vv > h * 0.5, 180.0 / (vv - h * 0.5 + 10.0), 18.0),
            1.5, 18.0).astype(np.float32)
    depth = jnp.asarray(depth_np)
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
    intr = jnp.asarray([cfg.fx, cfg.fy, cfg.cx, cfg.cy], jnp.float32)
    tiled = raycast_tiled(cfg, state, slots, mask, origin, eye, intr,
                          interpret=True)
    got = _port_raycast(cfg, state, origin, slots, mask, eye)
    gt_m = depth_np < 17.5
    cov = got.hit.numpy()[gt_m].mean()
    cov_tiled = np.asarray(tiled.hit)[gt_m].mean()
    assert cov >= cov_tiled - 0.01, (cov, cov_tiled)
    err = np.abs(got.depth.numpy() - depth_np)[got.hit.numpy() & gt_m]
    assert np.median(err) < cfg.voxel_size


def test_raycast_empty_map():
    cfg_j = _cfg()
    cfg = convert.tsdf_config_from_jax(cfg_j)
    state = tt.create_state(cfg, "cpu")
    eye = torch.eye(4)
    origin = tt.compute_origin(cfg, eye)
    grid = tt.build_local_grid(cfg, state, origin)
    slots, mask = tt.visible_blocks(cfg, state, grid, origin, eye)
    rc = tr.raycast(cfg, state, grid, origin, slots, mask, eye)
    assert not rc.hit.any() and (rc.depth == 0).all()
    assert int(rc.march_samples) == 0
