"""Which render is nearer the surface: the port's K2 rule (its plain twin,
``raycast_ref``), the JAX package's Pallas raycast (interpret mode, 256
candidate blocks a tile, the settled render rule of the slice tests) and
both packages' dense tracers, against the synthetic renderer's exact
depth, pixel by pixel.

The map: the port's staged static slice (test_torch_dynslam.py's
configuration, scene-flow odometry, 5 frames of a ``write_kitti_sequence``
folder at 160x120), carried to the JAX package by ``convert.py``, so that
every render reads the same map from the last frame's estimated pose; the
truth is the renderer's depth from that pose. Only pixels that all four
renders hit and whose true depth lies in (0.5 m, max_depth) count.

Measured: K2 is nearer the surface than the Pallas raycast: median
|error| 32.6 mm against 35.8 mm, 90th percentile 93.5 against 96.0 mm,
nearer on 53% of the pixels. Both kernel renders sit about 11 mm in
front of the surface (median signed error). The dense tracers, equal to
each other, are nearer still: median 19.1 mm, 90th percentile 51.5 mm,
1.8 mm in front. The bounds below hold these with a margin.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.ops import pallas_raycast as jpr
from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.config import Intrinsics
from dynslam_tpu_torch.io.synthetic import (
    SyntheticScene, render_stereo_frame, write_kitti_sequence,
)
from dynslam_tpu_torch.ops import tsdf as tt
from dynslam_tpu_torch.pipeline import builder as tb

from test_torch_dynslam import CFG, N_FRAMES, H, W
from test_torch_eval import to_port
from torch_frontend_inputs import RENDER_CAND_K

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("truth"))
    scene_seed = 0
    write_kitti_sequence(root, num_frames=N_FRAMES, width=W, height=H,
                         seed=scene_seed)
    cfg = dataclasses.replace(CFG, evaluation=dataclasses.replace(
        CFG.evaluation, enabled=False))
    dyn, inp = tb.build_dynslam(root, to_port(cfg), device="cpu")
    while dyn.process_frame(inp):
        pass
    eng = dyn.static_scene
    tcfg, c2w = eng.cfg, eng.cam_to_world
    intr = eng.intrinsics_vec.numpy()
    jcfg = jt.TsdfConfig(**{f.name: getattr(tcfg, f.name)
                            for f in dataclasses.fields(tcfg)})
    js = jt.TsdfState(**{k: jnp.asarray(v) for k, v in
                         convert.tsdf_state_to_numpy(eng.state).items()})
    origin = jt.compute_origin(jcfg, jnp.asarray(c2w))
    grid = jt.build_local_grid(jcfg, js, origin)
    slots, mask = jt.visible_blocks(jcfg, js, grid, origin,
                                    jnp.linalg.inv(jnp.asarray(c2w)))
    renders = {
        "k2": eng.get_raycast().depth.numpy(),
        "pallas": np.asarray(jpr.raycast_tiled(
            dataclasses.replace(jcfg, raycast_cand_k=RENDER_CAND_K), js,
            slots, mask, origin, jnp.asarray(c2w), jnp.asarray(intr),
            interpret=True).depth),
        "jax_dense": np.asarray(jt.raycast(
            jcfg, js, grid, origin, jnp.asarray(c2w),
            jnp.asarray(intr)).depth),
        "port_dense": tt.raycast(
            tcfg, eng.state, torch.tensor(np.asarray(grid)),
            torch.tensor(np.asarray(origin)), torch.from_numpy(c2w),
            torch.from_numpy(intr)).depth.numpy(),
    }
    truth = render_stereo_frame(
        SyntheticScene.default_scene(seed=scene_seed), c2w.astype(np.float64),
        Intrinsics(*(float(x) for x in intr)), dyn.config.calibration, W,
        H)["depth_m"]
    common = (truth > 0.5) & (truth < cfg.max_depth_m)
    for d in renders.values():
        common &= d > 0
    return {k: (d - truth)[common] for k, d in renders.items()}


def _stats(e):
    a = np.abs(e)
    return np.median(a), np.percentile(a, 90), np.median(e)


def test_k2_nearer_than_pallas(errors):
    """(``pytest -s`` prints the measurement the module docstring quotes.)"""
    assert errors["k2"].size > 3000
    for name, e in errors.items():
        print(name, "median |error|, 90th percentile, median signed error "
              "(mm):", [round(float(x) * 1e3, 1) for x in _stats(e)])
    nearer = (np.abs(errors["k2"]) < np.abs(errors["pallas"])).mean()
    print(f"K2 nearer than Pallas on {nearer:.3f} of {errors['k2'].size} "
          "pixels")
    k2, pal = _stats(errors["k2"]), _stats(errors["pallas"])
    assert k2[0] < pal[0] and k2[1] <= pal[1], (k2, pal)
    assert k2[0] <= 0.04 and k2[1] <= 0.1
    assert (np.abs(errors["k2"]) < np.abs(errors["pallas"])).mean() > 0.5
    # both kernel renders lie a centimetre in front of the surface
    assert -0.02 < k2[2] < 0 and -0.02 < pal[2] < 0


def test_dense_tracers_nearest(errors):
    jd, td = errors["jax_dense"], errors["port_dense"]
    assert np.median(np.abs(jd - td)) <= 1e-5
    dense = _stats(td)
    assert dense[0] < _stats(errors["k2"])[0]
    assert dense[0] <= 0.025 and dense[1] <= 0.06 and abs(dense[2]) < 0.005
