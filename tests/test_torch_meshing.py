"""The port's meshing (``viz/meshing.py``) against the JAX package's on
the same maps, carried across by ``convert.py``: the vertices and
triangles equal exactly (same values, same order), the OBJ files byte
for byte but for their comment line. Maps: test_torch_tsdf's two fused
views, test_meshing.py's fronto-parallel wall, an empty pool; the engine
and pool-slot entry points too."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.config import Intrinsics
from dynslam_tpu.io.synthetic import Box, SyntheticScene, render_frame
from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu.viz import meshing as jmesh
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.ops import tsdf as tt
from dynslam_tpu_torch.viz import meshing as tmesh

from test_torch_tsdf import _cfg, _np, make_views
from torch_threads import threads

torch_threads = threads(2)

W, H = 128, 96
INTR = Intrinsics(110.0, 110.0, W / 2, H / 2)
#: tests/test_meshing.py's configuration
WALL_CFG = jt.TsdfConfig(
    pool_capacity=4096, local_dims=(48, 32, 48), max_new_blocks=2048,
    max_visible_blocks=3072, voxel_size=0.08, mu=0.32, width=W, height=H,
    fx=INTR.fx, fy=INTR.fy, cx=INTR.cx, cy=INTR.cy)


def _fuse(jcfg, views):
    js = jt.create_state(jcfg)
    for frame, (depth, rgb, c2w) in enumerate(views):
        w2c = jnp.asarray(np.linalg.inv(c2w).astype(np.float32))
        o = jt.compute_origin(jcfg, jnp.asarray(c2w))
        g = jt.build_local_grid(jcfg, js, o)
        js, g, _ = jt.allocate(jcfg, js, g, o, jnp.asarray(depth),
                               jnp.asarray(c2w), jnp.int32(frame))
        sl, m = jt.visible_blocks(jcfg, js, g, o, w2c)
        js = jt.integrate(jcfg, js, sl, m, jnp.asarray(rgb),
                          jnp.asarray(depth), w2c, jnp.int32(frame))
    return js


def _wall_views():
    """tests/test_meshing.py's wall at z = 5 m, seen from the origin."""
    pose = np.eye(4)
    pose[:3, 3] = [0, 0, 7.03]
    scene = SyntheticScene(ground_y=1e9,
                           boxes=[Box(np.array([4.0, 3.0, 2.0]), pose)])
    fr = render_frame(scene, np.eye(4), INTR, W, H, supersample=1)
    depth = np.where((fr["depth_m"] >= 0.5) & (fr["depth_m"] <= 19),
                     fr["depth_m"], 0).astype(np.float32)
    return [(depth, np.zeros((H, W, 3), np.uint8), np.eye(4, dtype=np.float32))]


@pytest.fixture(scope="module")
def maps():
    views_cfg = _cfg()
    return {"views": (views_cfg, _fuse(views_cfg, make_views())),
            "wall": (WALL_CFG, _fuse(WALL_CFG, _wall_views())),
            "empty": (WALL_CFG, jt.create_state(WALL_CFG))}


@pytest.mark.parametrize("name,min_tris", [("views", 100_000), ("wall", 100),
                                           ("empty", 0)])
def test_extract_mesh_matches_jax(maps, tmp_path, name, min_tris):
    jcfg, js = maps[name]
    ts = convert.tsdf_state_from_numpy(_np(js), "cpu")
    vj, tj = jmesh.extract_mesh(js, jcfg.voxel_size)
    vt, tri = tmesh.extract_mesh(ts, jcfg.voxel_size)
    assert vt.dtype == torch.float32 and tri.dtype == torch.int32
    assert np.array_equal(vj, vt.numpy()) and np.array_equal(tj, tri.numpy())
    assert len(tj) >= min_tris and (len(tj) > 0) == (name != "empty")
    if len(tj):
        assert tri.min() >= 0 and tri.max() < len(vt)
    pj, pt = str(tmp_path / "jax.obj"), str(tmp_path / "port.obj")
    jmesh.write_obj(pj, vj, tj)
    tmesh.write_obj(pt, vt, tri)
    a, b = open(pj).read().split("\n", 1), open(pt).read().split("\n", 1)
    assert a[1] == b[1]
    assert b[0] == (f"# dynslam_tpu_torch mesh: {len(vj)} verts, "
                    f"{len(tj)} tris")


@pytest.mark.parametrize("min_weight", [0.5, 2.0])
def test_min_weight_matches_jax(maps, min_weight):
    jcfg, js = maps["views"]
    vj, tj = jmesh.extract_mesh(js, jcfg.voxel_size, min_weight)
    vt, tri = tmesh.extract_mesh(
        convert.tsdf_state_from_numpy(_np(js), "cpu"), jcfg.voxel_size,
        min_weight)
    assert np.array_equal(vj, vt.numpy()) and np.array_equal(tj, tri.numpy())


def test_wall_mesh_on_surface(maps):
    """tests/test_meshing.py's geometry check on the port's mesh: most
    vertices lie within two voxels of the wall's front face."""
    jcfg, js = maps["wall"]
    vt, tri = tmesh.extract_mesh(
        convert.tsdf_state_from_numpy(_np(js), "cpu"), jcfg.voxel_size)
    z = vt.numpy()[:, 2]
    assert (np.abs(z - 5.03) < 2 * jcfg.voxel_size).mean() > 0.8


def test_save_engine_mesh_on_engine_and_pool_slot(maps, tmp_path):
    """``save_engine_mesh`` on a ``MapEngine`` and on a pooled volume's
    slot writes the JAX package's file for the same map."""
    from dynslam_tpu_torch.config import VoxelDecayParams
    from dynslam_tpu_torch.instances.volume_pool import InstanceVolumePool
    from dynslam_tpu_torch.pipeline.mapping import MapEngine

    jcfg, js = maps["wall"]
    cfg = convert.tsdf_config_from_jax(jcfg)
    state = convert.tsdf_state_from_numpy(_np(js), "cpu")
    want = str(tmp_path / "want.obj")
    n_want = jmesh.save_engine_mesh(type("E", (), {"state": js,
                                                   "cfg": jcfg})(), want)
    eng = MapEngine(cfg, VoxelDecayParams(), device="cpu")
    eng.state = state
    pool = InstanceVolumePool(cfg, VoxelDecayParams(), capacity=2,
                              device="cpu")
    vol = pool.acquire_volume()
    tt.assign_state(pool.slot_state(vol.slot), state)
    for what, engine in (("engine", eng), ("slot", vol)):
        path = str(tmp_path / f"{what}.obj")
        assert tmesh.save_engine_mesh(engine, path) == n_want > 100
        assert open(path).read().split("\n", 1)[1] == \
            open(want).read().split("\n", 1)[1]
        assert os.path.getsize(path) > 10_000
