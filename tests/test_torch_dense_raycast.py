"""The port's dense free-camera tracer (``ops/tsdf.py::compute_block_df``
and ``raycast``) against the JAX package's on the same map (the JAX map
carried across by ``convert.py``), and ``features.refine_stereo_disparity``
against the JAX package's.

Tolerances: the block distance field is exact; a render holds hits on
>= 99.9% of the pixels in agreement and a median |depth gap| <= 1e-5 m
where both hit, colour and weight equal on >= 99.9% of those (measured:
hits equal, depths bit-exact on 98.9% of the pixels and 1 ulp apart on
the rest); ``refine_stereo_disparity`` is exact on integer-valued images.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.ops import features as jf
from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.ops import features as tf
from dynslam_tpu_torch.ops import tsdf as tt

from test_torch_tsdf import _cfg, _np, make_views
from torch_threads import threads

torch_threads = threads(2)

MIN_HIT_AGREE, MAX_MEDIAN_GAP_M, MIN_SAME_COLOR = 0.999, 1e-5, 0.999


@pytest.fixture(scope="module")
def scene():
    """The JAX map fused from test_torch_tsdf's two views, its copy in the
    port, and the second view's window."""
    jcfg = _cfg()
    js = jt.create_state(jcfg)
    views = make_views()
    for frame, (depth, rgb, c2w) in enumerate(views):
        w2c = jnp.asarray(np.linalg.inv(c2w).astype(np.float32))
        o = jt.compute_origin(jcfg, jnp.asarray(c2w))
        g = jt.build_local_grid(jcfg, js, o)
        js, g, _ = jt.allocate(jcfg, js, g, o, jnp.asarray(depth),
                               jnp.asarray(c2w), jnp.int32(frame))
        sl, m = jt.visible_blocks(jcfg, js, g, o, w2c)
        js = jt.integrate(jcfg, js, sl, m, jnp.asarray(rgb),
                          jnp.asarray(depth), w2c, jnp.int32(frame))
    c2w = views[1][2]
    origin = jt.compute_origin(jcfg, jnp.asarray(c2w))
    grid = jt.build_local_grid(jcfg, js, origin)
    return dict(jcfg=jcfg, cfg=convert.tsdf_config_from_jax(jcfg), js=js,
                ts=convert.tsdf_state_from_numpy(_np(js), "cpu"), c2w=c2w,
                origin=origin, grid=grid)


@pytest.mark.parametrize("df_cap", [8, 3])
def test_block_df_exact(scene, df_cap):
    import dataclasses

    jcfg = dataclasses.replace(scene["jcfg"], df_cap=df_cap)
    cfg = convert.tsdf_config_from_jax(jcfg)
    want = np.asarray(jt.compute_block_df(jcfg, scene["grid"]))
    got = tt.compute_block_df(cfg, torch.tensor(np.asarray(scene["grid"])))
    assert got.dtype == torch.int8
    assert np.array_equal(want, got.numpy())
    assert set(np.unique(want)) == set(range(df_cap + 1))


@pytest.mark.parametrize("size", [None, (128, 80), (97, 61)],
                         ids=["frame", "half", "odd"])
def test_raycast_matches_jax(scene, size):
    """At the frame size and at two rescaled ones, with the frame's
    intrinsics (a rescaled render sees the top-left part of the view, as
    the JAX engine renders it)."""
    cfg = scene["cfg"]
    w, h = size or (None, None)
    intr = np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy], np.float32)
    rj = jt.raycast(scene["jcfg"], scene["js"], scene["grid"],
                    scene["origin"], jnp.asarray(scene["c2w"]),
                    jnp.asarray(intr), w, h)
    rt = tt.raycast(cfg, scene["ts"], torch.tensor(np.asarray(scene["grid"])),
                    torch.tensor(np.asarray(scene["origin"])),
                    torch.from_numpy(scene["c2w"]), torch.from_numpy(intr),
                    w, h)
    hj, ht = np.asarray(rj.hit), rt.hit.numpy()
    assert ht.shape == (h or cfg.height, w or cfg.width)
    both = hj & ht
    assert (hj == ht).mean() >= MIN_HIT_AGREE
    assert both.sum() > 200
    gap = np.abs(np.asarray(rj.depth) - rt.depth.numpy())[both]
    assert np.median(gap) <= MAX_MEDIAN_GAP_M
    same = (np.asarray(rj.color) == rt.color.numpy()).all(-1) \
        & (np.asarray(rj.weight) == rt.weight.numpy())
    assert same[both].mean() >= MIN_SAME_COLOR
    assert int(rt.march_samples) > 0


def test_raycast_empty_map(scene):
    """No allocated block: every ray misses."""
    cfg = scene["cfg"]
    ts = tt.create_state(cfg, "cpu")
    origin = tt.compute_origin(cfg, torch.from_numpy(scene["c2w"]))
    grid = tt.build_local_grid(cfg, ts, origin)
    rt = tt.raycast(cfg, ts, grid, origin, torch.from_numpy(scene["c2w"]),
                    torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy]), 64, 40)
    assert not rt.hit.any() and (rt.depth == 0).all()
    assert (rt.color == 0).all() and (rt.weight == 0).all()


@pytest.mark.parametrize("u_frac", [0.0, 0.37], ids=["integer", "subpixel"])
def test_refine_stereo_disparity_exact(u_frac):
    rng = np.random.default_rng(5)
    h, w, m = 48, 80, 64
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    # the right image: the left one shifted by 6 px, with noise
    right = np.roll(left, -6, axis=1) + rng.integers(-3, 4, (h, w))
    right = right.astype(np.float32)
    ul = rng.integers(0, w, m).astype(np.float32) + u_frac
    vl = rng.integers(0, h, m).astype(np.float32)
    ur = ul - 6.0 + rng.integers(-1, 2, m)
    want = np.asarray(jf.refine_stereo_disparity(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(ul),
        jnp.asarray(vl), jnp.asarray(ur)))
    got = tf.refine_stereo_disparity(
        torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(ul),
        torch.from_numpy(vl), torch.from_numpy(ur))
    assert np.array_equal(want, got.numpy())
    assert np.abs(want - (ul - 6.0)).max() <= 1.5
