"""TSDF fusion: the port's plain version ``integrate_ref`` against the
JAX package's exact rule ``tsdf.integrate`` (the oracle of the CUDA
kernel ``csrc/integrate.cu``) on the test_pallas_integrate scene, two
views fused in a row by each side."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.ops import integrate as ti
from dynslam_tpu_torch.ops import tsdf as tt

from test_torch_tsdf import _cfg, views  # noqa: F401  (fixture)
from torch_threads import threads

torch_threads = threads(2)


def _fuse_both(views, cfg_j):
    cfg = convert.tsdf_config_from_jax(cfg_j)
    js = jt.create_state(cfg_j)
    ts = tt.create_state(cfg, "cpu")
    for frame, (depth, rgb, c2w) in enumerate(views):
        w2c = np.linalg.inv(c2w).astype(np.float32)
        o = jt.compute_origin(cfg_j, jnp.asarray(c2w))
        g = jt.build_local_grid(cfg_j, js, o)
        js, g, _ = jt.allocate(cfg_j, js, g, o, jnp.asarray(depth),
                               jnp.asarray(c2w), jnp.int32(frame))
        sl, m = jt.visible_blocks(cfg_j, js, g, o, jnp.asarray(w2c))
        js = jt.integrate(cfg_j, js, sl, m, jnp.asarray(rgb),
                          jnp.asarray(depth), jnp.asarray(w2c),
                          jnp.int32(frame))
        to = tt.compute_origin(cfg, torch.from_numpy(c2w))
        tg = tt.build_local_grid(cfg, ts, to)
        ts, tg, _ = tt.allocate(cfg, ts, tg, to, torch.from_numpy(depth),
                                torch.from_numpy(c2w), frame)
        tsl, tm = tt.visible_blocks(cfg, ts, tg, to, torch.from_numpy(w2c))
        out = ti.integrate(cfg, ts, tsl, tm, torch.from_numpy(rgb),
                           torch.from_numpy(depth), torch.from_numpy(w2c),
                           frame)
        assert out is ts  # in place
    return ({k: np.asarray(getattr(js, k)) for k in convert.STATE_KEYS},
            convert.tsdf_state_to_numpy(ts))


def assert_words_close(ref: np.ndarray, got: np.ndarray):
    """Packed (sdf_i16 << 16 | w_u16) words: >= 99.9% bit-exact, the rest
    within one SDF quantum (1/32767) and one weight quantum (1/64) — the
    float rounding of the two frameworks may differ by one unit."""
    exact = (ref == got).mean()
    assert exact >= 0.999, f"bit-exact words {exact:.5f}"
    ds = np.abs((ref >> 16) - (got >> 16))
    dw = np.abs((ref & 0xFFFF) - (got & 0xFFFF))
    assert ds.max() <= 1 and dw.max() <= 1, (ds.max(), dw.max())


def assert_colors_close(ref: np.ndarray, got: np.ndarray):
    """Packed 0x00RRGGBB: every channel within +-1 on >= 99.5% of voxels."""
    ch = [np.abs(((ref >> s) & 0xFF) - ((got >> s) & 0xFF))
          for s in (16, 8, 0)]
    close = np.maximum.reduce(ch) <= 1
    assert close.mean() >= 0.995, close.mean()


@pytest.mark.parametrize("use_depth_weighting", [False, True])
def test_integrate_ref_words_equal_jax(views, use_depth_weighting):  # noqa: F811
    """On the same views and poses the twin's words equal XLA's word for
    word, depth weighting included: its ``max_depth / d`` is a true
    division there, not a reciprocal times the scalar (which parted 83
    words of this scene by a quantum)."""
    import dataclasses

    cfg_j = dataclasses.replace(_cfg(),
                                use_depth_weighting=use_depth_weighting)
    jn, tn = _fuse_both(views, cfg_j)
    assert np.array_equal(jn["tsdf_w"], tn["tsdf_w"])


@pytest.mark.parametrize("use_depth_weighting", [False, True])
def test_integrate_ref_matches_jax(views, use_depth_weighting):  # noqa: F811
    import dataclasses

    cfg_j = dataclasses.replace(_cfg(),
                                use_depth_weighting=use_depth_weighting)
    jn, tn = _fuse_both(views, cfg_j)
    for k in ("valid", "block_coords", "alloc_frame", "last_seen"):
        assert np.array_equal(jn[k], tn[k]), k
    used = np.nonzero(jn["valid"])[0][:-1]  # minus the scratch row
    assert used.size > 300
    assert_words_close(jn["tsdf_w"][used], tn["tsdf_w"][used])
    assert_colors_close(jn["color"][used], tn["color"][used])
    untouched = ~jn["valid"]
    untouched[-1] = True
    assert np.array_equal(jn["tsdf_w"][untouched], tn["tsdf_w"][untouched])
    assert np.array_equal(jn["color"][untouched], tn["color"][untouched])
    observed = (tn["tsdf_w"][used] & 0xFFFF) > 0
    assert observed.mean() > 0.2


def test_integrate_dispatch_cpu_and_refusal():
    """CPU tensors take the plain version (no kernel launch); a device
    the port has no kernel for is refused, never silently computed."""
    cfg = tt.TsdfConfig(pool_capacity=64, local_dims=(8, 8, 8),
                        max_new_blocks=16, max_visible_blocks=16, width=8,
                        height=4)
    state = tt.create_state(cfg, "cpu")
    args = (torch.zeros(16, dtype=torch.int32),
            torch.zeros(16, dtype=torch.bool),
            torch.zeros(4, 8, 3, dtype=torch.uint8), torch.zeros(4, 8),
            torch.eye(4), 0)
    before = ti.integrate.launches
    ti.integrate(cfg, state, *args)
    assert ti.integrate.launches == before
    meta = tt.TsdfState(*(getattr(state, k).to("meta")
                          for k in convert.STATE_KEYS))
    with pytest.raises(ValueError, match="unsupported device"):
        ti.integrate(cfg, meta, *(a.to("meta") if torch.is_tensor(a) else a
                                  for a in args))


#: (pool slot, crop origin (u0, v0), view) of the volume-axis case: three
#: volumes of a four-slot pool, each fused from a 64x128 crop of a view
#: with its principal point shifted by the crop origin
VOLUMES = ((2, (64, 32), 0), (0, (0, 96), 1), (3, (128, 48), 0))
CROP_H, CROP_W = 64, 128


def test_integrate_many_matches_jax_on_crops(views):  # noqa: F811
    """The volume axis: ``integrate_many`` fuses n = 3 volumes of a stacked
    pool, each from its own crop, pose, shifted ``intr4`` and frame index,
    in one call; each volume is held to ``tsdf.integrate`` at the crop's
    shape to the single-volume bound, and the slot fused by no volume
    stays as it was."""
    import dataclasses

    cfg_j = dataclasses.replace(_cfg(), width=CROP_W, height=CROP_H)
    cfg = convert.tsdf_config_from_jax(cfg_j)
    pool = tt.create_pool(cfg, 4, "cpu")
    fresh = {k: v.copy() for k, v in convert.tsdf_state_to_numpy(
        tt.pool_slot(pool, 1)).items()}
    args, jax_states = [], []
    for frame, (s, (u0, v0), vi) in enumerate(VOLUMES, start=1):
        depth, rgb, c2w = views[vi]
        d = np.ascontiguousarray(depth[v0: v0 + CROP_H, u0: u0 + CROP_W])
        im = np.ascontiguousarray(rgb[v0: v0 + CROP_H, u0: u0 + CROP_W])
        intr4 = np.asarray([cfg.fx, cfg.fy, cfg.cx - u0, cfg.cy - v0],
                           np.float32)
        w2c = np.linalg.inv(c2w).astype(np.float32)
        js = jt.create_state(cfg_j)
        o = jt.compute_origin(cfg_j, jnp.asarray(c2w))
        g = jt.build_local_grid(cfg_j, js, o)
        js, g, _ = jt.allocate(cfg_j, js, g, o, jnp.asarray(d),
                               jnp.asarray(c2w), jnp.int32(frame),
                               intr4=jnp.asarray(intr4))
        sl, m = jt.visible_blocks(cfg_j, js, g, o, jnp.asarray(w2c),
                                  intr4=jnp.asarray(intr4))
        jax_states.append(jt.integrate(
            cfg_j, js, sl, m, jnp.asarray(im), jnp.asarray(d),
            jnp.asarray(w2c), jnp.int32(frame), intr4=jnp.asarray(intr4)))
        st = tt.pool_slot(pool, s)
        to = tt.compute_origin(cfg, torch.from_numpy(c2w))
        tg = tt.build_local_grid(cfg, st, to)
        tt.allocate(cfg, st, tg, to, torch.from_numpy(d),
                    torch.from_numpy(c2w), frame, intr4=torch.tensor(intr4))
        tsl, tm = tt.visible_blocks(cfg, st, tg, to, torch.from_numpy(w2c),
                                    intr4=torch.tensor(intr4))
        args.append((tsl, tm, torch.from_numpy(im), torch.from_numpy(d),
                     torch.from_numpy(w2c), frame, torch.tensor(intr4)))
    slots, masks, rgbs, depths, w2cs, frames, intr4s = zip(*args)
    out = ti.integrate_many(cfg, pool, [v[0] for v in VOLUMES],
                            torch.stack(slots), torch.stack(masks),
                            torch.stack(rgbs), torch.stack(depths),
                            torch.stack(w2cs), list(frames),
                            torch.stack(intr4s))
    assert out is pool  # in place
    for (s, _, _), js in zip(VOLUMES, jax_states):
        jn = {k: np.asarray(getattr(js, k)) for k in convert.STATE_KEYS}
        tn = convert.tsdf_state_to_numpy(tt.pool_slot(pool, s))
        for k in ("valid", "block_coords", "alloc_frame", "last_seen"):
            assert np.array_equal(jn[k], tn[k]), (s, k)
        used = np.nonzero(jn["valid"])[0][:-1]
        assert used.size > 50, s
        assert_words_close(jn["tsdf_w"][used], tn["tsdf_w"][used])
        assert_colors_close(jn["color"][used], tn["color"][used])
        assert ((tn["tsdf_w"][used] & 0xFFFF) > 0).mean() > 0.2
    untouched = convert.tsdf_state_to_numpy(tt.pool_slot(pool, 1))
    for k in convert.STATE_KEYS:
        assert np.array_equal(untouched[k], fresh[k]), k
    two = (torch.stack(slots[:2]), torch.stack(masks[:2]),
           torch.stack(rgbs[:2]), torch.stack(depths[:2]),
           torch.stack(w2cs[:2]), [1, 2], torch.stack(intr4s[:2]))
    with pytest.raises(ValueError, match="distinct"):
        ti.integrate_many(cfg, pool, [0, 0], *two)
    with pytest.raises(ValueError, match="outside the pool"):
        ti.integrate_many(cfg, pool, [0, 4], *two)
