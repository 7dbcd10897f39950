"""RANSAC egomotion: the port against ``dynslam_tpu/ops/egomotion.py``
fed the same matches and JAX's own hypothesis draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.ops import egomotion as je
from dynslam_tpu.ops import features as jf
from dynslam_tpu_torch.ops import egomotion as te

from torch_frontend_inputs import (
    CALIB, INTR, VO, jax_sample_ids, make_frames,
)
from torch_threads import threads

torch_threads = threads(2)


@pytest.fixture(scope="module")
def frames():
    return make_frames()


def test_motion_matches_jax_with_its_draws(frames):
    fr, _ = frames
    J = [jf.detect_features_pair(jnp.asarray(l), jnp.asarray(r), VO)
         for (l, r) in fr]
    fj, vj = jf.circular_match(J[1][0], J[1][1], J[0][0], J[0][1], VO)
    imgs = (fr[1][0], fr[1][1], fr[0][0], fr[0][1])
    rj = np.asarray(jf.refine_flow_quad(*map(jnp.asarray, imgs), fj))
    m = np.asarray(vj)
    flow = np.where(m[:, None], rj, np.asarray(fj)).astype(np.float32)
    calib_vec = np.asarray([INTR.fx, INTR.cx, INTR.cy, CALIB.baseline_m],
                           np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    est_j = je.estimate_motion(jnp.asarray(flow), jnp.asarray(m),
                               jnp.asarray(calib_vec), key,
                               jnp.zeros(6, jnp.float32), VO)
    ids = jax_sample_ids(key, m, VO.ransac_iters)
    est_t = te.estimate_motion(torch.tensor(flow), torch.tensor(m),
                               torch.tensor(calib_vec), torch.zeros(6), VO,
                               sample_ids=torch.tensor(ids))
    assert bool(est_j.success) and bool(est_t.success)
    assert np.abs(np.asarray(est_j.tr) - est_t.tr.numpy()).max() <= 1e-4
    assert abs(int(est_j.num_inliers) - int(est_t.num_inliers)) <= 2
    assert np.allclose(np.asarray(est_j.matrix), est_t.matrix.numpy(),
                       atol=1e-4)

    # the default draws come from a torch.Generator: same motion to VO
    # accuracy, reproducible from its seed
    runs = [te.estimate_motion(torch.tensor(flow), torch.tensor(m),
                               torch.tensor(calib_vec), torch.zeros(6), VO,
                               generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0].tr, runs[1].tr)
    assert np.abs(runs[0].tr.numpy() - est_t.tr.numpy()).max() < 5e-3


def test_estimate_motion_fails_on_too_few_matches():
    flow = torch.zeros(32, 8)
    valid = torch.zeros(32, dtype=torch.bool)
    valid[:4] = True
    est = te.estimate_motion(flow, valid, torch.tensor([160.0, 96, 48, 0.5]),
                             torch.zeros(6), VO,
                             generator=torch.Generator().manual_seed(0))
    assert not bool(est.success)
    assert torch.equal(est.matrix, torch.eye(4))


def test_mask_batched_motion_matches_jax_vmap(frames):
    """The mask-batched estimator against the JAX dynamic step's
    ``jax.vmap(per_mask)`` form: K = 3 masks of the frame pair's matches
    (two column bands and one with too few matches to succeed), each
    compacted to 256 rows as the step does, with JAX's per-mask draws and
    the per-object RANSAC parameters; and against K separate single-mask
    calls of the port."""
    import dataclasses

    from dynslam_tpu.config import TrackerParams
    from dynslam_tpu.ops import tsdf as jt

    fr, _ = frames
    tp = TrackerParams()
    params = dataclasses.replace(VO, ransac_iters=tp.object_ransac_iters,
                                 irls_rounds=tp.object_irls_rounds,
                                 gn_iters=tp.object_gn_iters)
    J = [jf.detect_features_pair(jnp.asarray(l), jnp.asarray(r), VO)
         for (l, r) in fr]
    fj, vj = jf.circular_match(J[1][0], J[1][1], J[0][0], J[0][1], VO)
    flow = np.asarray(fj).astype(np.float32)
    valid = np.asarray(vj)
    u = flow[:, 4]
    few = np.zeros_like(valid)
    few[np.flatnonzero(valid)[:4]] = True
    sels = [valid & (u < 96), valid & (u >= 96), few]
    assert sels[2].sum() < 6 <= min(sels[0].sum(), sels[1].sum())
    cap = 256
    rows, vmasks = [], []
    for sel in sels:
        idx = np.asarray(jt.compact_mask(jnp.asarray(sel), cap, 0))
        rows.append(flow[idx])
        vmasks.append(np.arange(cap) < sel.sum())
    flows, vmasks = np.stack(rows), np.stack(vmasks)
    calib_vec = np.asarray([INTR.fx, INTR.cx, INTR.cy, CALIB.baseline_m],
                           np.float32)
    warm = np.zeros((3, 6), np.float32)
    warm[1, 5] = -0.3
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    est_j = jax.vmap(lambda f, v, k, w: je.estimate_motion(
        f, v, jnp.asarray(calib_vec), k, w, params))(
        jnp.asarray(flows), jnp.asarray(vmasks), keys, jnp.asarray(warm))
    ids = np.stack([jax_sample_ids(keys[j], vmasks[j], params.ransac_iters)
                    for j in range(3)])
    est_t = te.estimate_motion_many(
        torch.tensor(flows), torch.tensor(vmasks), torch.tensor(calib_vec),
        torch.tensor(warm), params, sample_ids=torch.tensor(ids))
    assert est_t.tr.shape == (3, 6) and est_t.matrix.shape == (3, 4, 4)
    assert np.array_equal(np.asarray(est_j.success), est_t.success.numpy())
    assert est_t.success.tolist() == [True, True, False]
    assert np.abs(np.asarray(est_j.tr) - est_t.tr.numpy()).max() <= 1e-4
    assert np.abs(np.asarray(est_j.num_inliers)
                  - est_t.num_inliers.numpy()).max() <= 2
    assert torch.equal(est_t.matrix[2], torch.eye(4))
    for j in range(3):
        one = te.estimate_motion(
            torch.tensor(flows[j]), torch.tensor(vmasks[j]),
            torch.tensor(calib_vec), torch.tensor(warm[j]), params,
            sample_ids=torch.tensor(ids[j]))
        assert torch.allclose(one.tr, est_t.tr[j], atol=1e-6), j
        assert bool(one.success) == bool(est_t.success[j])
        assert int(one.num_inliers) == int(est_t.num_inliers[j])
