"""The staged path's sparse scene flow and VO (``pipeline/sparse_sf.py``)
against the JAX package's ``SparseSFProvider`` over three frames of the
tests/test_fused.py scene and a blank one, with the JAX package's RANSAC
draws fed through the port's ``sampler`` hook (the camera's from
``fold_in(key, counter)``, an object's from ``fold_in(key, 10_000_019 +
counter)``): the flow, the camera motion, the held motion after a failed
estimate, and object motions with the object IRLS/GN depths."""

import jax
import numpy as np
import pytest
import torch

from dynslam_tpu.io.synthetic import (
    SyntheticScene, render_stereo_frame, straight_trajectory,
)
from dynslam_tpu.pipeline.sparse_sf import SparseSFProvider as JaxSF
from dynslam_tpu_torch.pipeline.sparse_sf import (
    OBJECT_KEY_OFFSET, SparseSFProvider,
)

from test_torch_eval import to_port
from torch_frontend_inputs import CALIB, H, INTR, VO, W, jax_sample_ids
from torch_threads import threads

torch_threads = threads(2)

#: the two packages' flows agree to float order (LK refinement of the same
#: matches); motions after the same draws to 1e-4 (two Gauss-Newton
#: solvers in float32, as tests/test_torch_egomotion.py measures)
FLOW_ATOL, MOTION_ATOL = 1e-3, 1e-4


def frames(n=3):
    scene = SyntheticScene.default_scene(seed=3)
    poses = straight_trajectory(n, speed=0.5, yaw_rate=0.004)
    out = []
    for i in range(n):
        fr = render_stereo_frame(scene, poses[i], INTR, CALIB, W, H, frame=i)
        out.append(tuple(np.clip(fr[k] * 255, 0, 255).astype(np.float32)
                         for k in ("left_gray", "right_gray")))
    blank = np.zeros((H, W), np.float32)
    return out + [(blank, blank)]


def jax_sampler(base_key, iters):
    def sampler(index, valid):
        return torch.tensor(jax_sample_ids(
            jax.random.fold_in(base_key, index), valid.numpy(), iters))
    return sampler


@pytest.fixture(scope="module")
def run():
    js = JaxSF((INTR.fx, INTR.cx, INTR.cy), CALIB, VO)
    ts = SparseSFProvider((INTR.fx, INTR.cx, INTR.cy), to_port(CALIB),
                          to_port(VO), device="cpu",
                          sampler=jax_sampler(js._base_key, VO.ransac_iters))
    recs = []
    for lg, rg in frames():
        js.compute_sparse_sf(lg, rg)
        ts.compute_sparse_sf(lg, rg)
        recs.append(dict(
            flow=(js.flow_available(), ts.flow_available()),
            ok=(js.motion_available() if js.flow_available() else None,
                ts.motion_available() if ts.flow_available() else None),
            motion=(np.asarray(js.get_latest_motion()),
                    ts.get_latest_motion()),
            flows=(js.get_flow(), ts.get_flow())
            if js.flow_available() else None))
        if len(recs) == 3:
            matches = js.get_flow().matches
            left = matches[matches[:, 0] < W / 2]
            obj = [(js.extract_motion(m, None, irls_rounds=2, gn_iters=4),
                    ts.extract_motion(m, None, irls_rounds=2, gn_iters=4))
                   for m in (left, matches[:5])]
    return recs, obj, js, ts


def test_flow_and_camera_motion(run):
    recs, *_ = run
    assert recs[0]["flow"] == (False, False)
    for r in recs[1:3]:
        assert r["ok"] == (True, True)
        jf, tf = r["flows"]
        assert np.array_equal(jf.valid, tf.valid)
        assert jf.valid.sum() > 100
        assert np.abs(jf.flow[jf.valid] - tf.flow[tf.valid]).max() <= FLOW_ATOL
        a, b = r["motion"]
        assert b.dtype == np.float32
        assert np.abs(a - b).max() <= MOTION_ATOL


def test_failed_estimate_holds_the_motion(run):
    """The blank frame: no estimate, the last successful motion held."""
    recs, *_ = run
    assert recs[3]["ok"] == (False, False)
    for k in (0, 1):
        assert np.array_equal(recs[3]["motion"][k], recs[2]["motion"][k])


def test_object_motion(run):
    _, obj, js, ts = run
    (ja, ta), (jb, tb) = obj
    assert ja is not None and ta is not None
    assert np.abs(np.asarray(ja) - ta).max() <= MOTION_ATOL
    assert jb is None and tb is None  # fewer than 6 vectors


def test_object_draws_use_their_key_offset():
    seen = []

    def sampler(index, valid):
        seen.append(index)
        return torch.zeros(VO.ransac_iters, 3, dtype=torch.int64)

    ts = SparseSFProvider((INTR.fx, INTR.cx, INTR.cy), to_port(CALIB),
                          to_port(VO), device="cpu", sampler=sampler)
    for lg, rg in frames(2)[:2]:
        ts.compute_sparse_sf(lg, rg)
    ts.extract_motion(ts.get_flow().matches[:20])
    assert seen == [1, OBJECT_KEY_OFFSET + 2]
