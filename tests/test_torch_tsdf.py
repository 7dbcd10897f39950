"""The port's map core (``dynslam_tpu_torch/ops/tsdf.py``) against the
JAX package's ``ops/tsdf.py`` on the same numpy inputs. Integer state —
validity, block coords, allocation / last-seen frames, the local grid,
its origin, allocation counts and decay — must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.config import Intrinsics
from dynslam_tpu.io.synthetic import SyntheticScene, render_frame
from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.ops import tsdf as tt
from dynslam_tpu_torch.ops.integrate import integrate_ref
from torch_threads import threads

torch_threads = threads(2)

W, H = 256, 160
INTR = Intrinsics(140.0, 140.0, W / 2, H / 2)


def _cfg(pool_capacity=4096, max_new_blocks=2048):
    return jt.TsdfConfig(
        pool_capacity=pool_capacity, local_dims=(48, 24, 48),
        max_new_blocks=max_new_blocks,
        max_visible_blocks=min(1024, pool_capacity), voxel_size=0.08,
        mu=0.32, width=W, height=H, fx=INTR.fx, fy=INTR.fy, cx=INTR.cx,
        cy=INTR.cy)


def _pose(yaw, z):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[2, 3] = z
    return T


def make_views():
    """Two (depth, rgb, cam_to_world) views of the test_pallas_integrate
    scene."""
    scene = SyntheticScene.default_scene(seed=7)
    out = []
    for yaw, z in ((0.0, 0.0), (0.03, 0.4)):
        c2w = _pose(yaw, z)
        fr = render_frame(scene, c2w.astype(np.float64), INTR, W, H,
                          supersample=1)
        depth = np.where((fr["depth_m"] >= 2.5) & (fr["depth_m"] <= 19),
                         fr["depth_m"], 0.0).astype(np.float32)
        g = np.clip(fr["gray"] * 255, 0, 255).astype(np.uint8)
        out.append((depth, np.stack([g, g // 2, g // 3], -1), c2w))
    return out


@pytest.fixture(scope="module")
def views():
    return make_views()


def _np(state):
    return {k: np.asarray(getattr(state, k)) for k in convert.STATE_KEYS}


def test_packing_matches_jax():
    rng = np.random.default_rng(0)
    sdf = np.concatenate([rng.uniform(-1.3, 1.3, 5000),
                          [-1.0, 1.0, 0.0, -0.0, 1e-6, -1e-6]]).astype(
                              np.float32)
    weight = np.concatenate([rng.uniform(0, 1100, 5000),
                             [0.0, 100.0, 1.0, 1023.99, 2000.0, 0.5]]).astype(
                                 np.float32)
    pj = np.asarray(jt.pack_voxel(jnp.asarray(sdf), jnp.asarray(weight)))
    pt = tt.pack_voxel(torch.from_numpy(sdf), torch.from_numpy(weight))
    assert np.array_equal(pj, pt.numpy())
    assert np.array_equal(np.asarray(jt.unpack_sdf(jnp.asarray(pj))),
                          tt.unpack_sdf(pt).numpy())
    assert np.array_equal(np.asarray(jt.unpack_weight(jnp.asarray(pj))),
                          tt.unpack_weight(pt).numpy())
    assert (pj[-6:] >> 16).tolist()[:3] == [-32767, 32767, 0]
    rgb = np.concatenate([rng.uniform(-5, 260, (5000, 3)),
                          [[0, 0, 0], [255, 255, 255], [254.5, 0.49, 127.5]]
                          ]).astype(np.float32)
    cj = np.asarray(jt.pack_rgb(jnp.asarray(rgb)))
    ct = tt.pack_rgb(torch.from_numpy(rgb))
    assert np.array_equal(cj, ct.numpy())
    assert np.array_equal(np.asarray(jt.unpack_rgb(jnp.asarray(cj))),
                          tt.unpack_rgb(ct).numpy())
    assert int(jt.EMPTY_VOXEL) == tt.EMPTY_VOXEL


@pytest.mark.parametrize("pool_capacity,max_new_blocks",
                         [(4096, 2048), (520, 512)])
def test_map_integer_state_exact(views, pool_capacity, max_new_blocks):
    """create_state, compute_origin, build_local_grid, allocate and
    visible_blocks over two views; the small pool overflows, so the
    dropped-allocation count is exercised too."""
    jcfg = _cfg(pool_capacity, max_new_blocks)
    cfg = convert.tsdf_config_from_jax(jcfg)
    js = jt.create_state(jcfg)
    ts = tt.create_state(cfg, "cpu")
    for k, v in _np(js).items():
        assert np.array_equal(v, getattr(ts, k).numpy()), k
    dropped = 0
    for frame, (depth, rgb, c2w) in enumerate(views):
        w2c = np.linalg.inv(c2w).astype(np.float32)
        jo = jt.compute_origin(jcfg, jnp.asarray(c2w))
        to = tt.compute_origin(cfg, torch.from_numpy(c2w))
        assert np.array_equal(np.asarray(jo), to.numpy())
        jg = jt.build_local_grid(jcfg, js, jo)
        tg = tt.build_local_grid(cfg, ts, to)
        assert np.array_equal(np.asarray(jg), tg.numpy())
        js, jg, (jn, jd) = jt.allocate(jcfg, js, jg, jo, jnp.asarray(depth),
                                       jnp.asarray(c2w), jnp.int32(frame))
        ts, tg, (tn, td) = tt.allocate(cfg, ts, tg, to,
                                       torch.from_numpy(depth),
                                       torch.from_numpy(c2w), frame)
        assert (int(jn), int(jd)) == (int(tn), int(td))
        dropped += int(td)
        assert np.array_equal(np.asarray(jg), tg.numpy())
        jsl, jm = jt.visible_blocks(jcfg, js, jg, jo, jnp.asarray(w2c))
        tsl, tm = tt.visible_blocks(cfg, ts, tg, to, torch.from_numpy(w2c))
        assert np.array_equal(np.asarray(jm), tm.numpy())
        assert np.array_equal(np.asarray(jsl), tsl.numpy())
        js = jt.integrate(jcfg, js, jsl, jm, jnp.asarray(rgb),
                          jnp.asarray(depth), jnp.asarray(w2c),
                          jnp.int32(frame))
        integrate_ref(cfg, ts, tsl, tm, torch.from_numpy(rgb),
                      torch.from_numpy(depth), torch.from_numpy(w2c), frame)
        jn_, tn_ = _np(js), convert.tsdf_state_to_numpy(ts)
        for k in ("valid", "block_coords", "alloc_frame", "last_seen",
                  "decayed_blocks"):
            assert np.array_equal(jn_[k], tn_[k]), (frame, k)
    assert (dropped > 0) == (pool_capacity < 560)
    assert int(jt.memory_stats(jcfg, js)[0]) == int(tt.memory_stats(cfg,
                                                                    ts)[0])


@pytest.mark.parametrize("force_all", [False, True])
def test_decay_exact(views, force_all):
    """Decay of the same map (the JAX map carried across) is exact."""
    jcfg = _cfg()
    cfg = convert.tsdf_config_from_jax(jcfg)
    js = jt.create_state(jcfg)
    for frame, (depth, rgb, c2w) in enumerate(views):
        w2c = jnp.asarray(np.linalg.inv(c2w).astype(np.float32))
        o = jt.compute_origin(jcfg, jnp.asarray(c2w))
        g = jt.build_local_grid(jcfg, js, o)
        js, g, _ = jt.allocate(jcfg, js, g, o, jnp.asarray(depth),
                               jnp.asarray(c2w), jnp.int32(frame * 3))
        sl, m = jt.visible_blocks(jcfg, js, g, o, w2c)
        js = jt.integrate(jcfg, js, sl, m, jnp.asarray(rgb),
                          jnp.asarray(depth), w2c, jnp.int32(frame * 3))
    ts = convert.tsdf_state_from_numpy(_np(js), "cpu")
    js2, jf = jt.decay(jcfg, js, jnp.int32(5), jnp.float32(1.0),
                       jnp.int32(4), force_all=force_all)
    ts2, tf = tt.decay(cfg, ts, 5, 1.0, 4, force_all=force_all)
    assert int(jf) == int(tf) > 0
    jn_, tn_ = _np(js2), convert.tsdf_state_to_numpy(ts2)
    for k in convert.STATE_KEYS:
        assert np.array_equal(jn_[k], tn_[k]), k
