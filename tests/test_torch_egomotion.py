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


def synthetic_flow(K: int, N: int, seed: int):
    """K slots of N matches of random points 6-30 m ahead seen before and
    after a small known motion (viso2 twist), with pixel noise, 10%
    outliers and the last eighth of each slot invalid; with their
    calibration vector, warm starts and a generator's draws."""
    rng = np.random.default_rng(seed)
    fx, cu, cv, base = 160.0, 96.0, 48.0, 0.5
    flows = np.zeros((K, N, 8), np.float32)
    for k in range(K):
        P = np.stack([rng.uniform(-8, 8, N), rng.uniform(-2, 2, N),
                      rng.uniform(6, 30, N)], -1)
        tr = rng.normal(0, [0.01, 0.02, 0.01, 0.1, 0.05, 0.5])
        Q = P @ se3_np(tr)[:3, :3].T + tr[3:]

        def proj(X):
            return (fx * X[:, 0] / X[:, 2] + cu, fx * X[:, 1] / X[:, 2] + cv,
                    fx * (X[:, 0] - base) / X[:, 2] + cu)

        ul, vl, ur = proj(Q)
        u1, v1, u2 = proj(P)
        f = np.stack([ul, vl, ur, vl, u1, v1, u2, v1], -1)
        f += rng.normal(0, 0.3, f.shape)
        out = rng.random(N) < 0.1
        f[out, :4] += rng.uniform(-20, 20, (int(out.sum()), 4))
        flows[k] = f
    valid = np.ones((K, N), bool)
    valid[:, N - N // 8:] = False
    calib_vec = torch.tensor([fx, cu, cv, base], dtype=torch.float32)
    return (torch.tensor(flows), torch.tensor(valid), calib_vec,
            torch.zeros(K, 6))


def se3_np(tr):
    from dynslam_tpu_torch.utils.se3 import np_twist_to_transform

    return np_twist_to_transform(tr)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper hands CPU tensors to ``estimate_motion_many_plain`` and
    returns what it returns, bit for bit, with given draws and with a
    generator's, and launches nothing."""
    import dataclasses

    flow, valid, calib_vec, warm = synthetic_flow(3, 96, seed=7)
    params = dataclasses.replace(VO, ransac_iters=40)
    ids = te.draw_sample_ids(valid, params.ransac_iters,
                             torch.Generator().manual_seed(1))
    before = te.launches
    for case in ("int64 draws", "int32 draws", "generator"):
        def draws():  # a fresh generator for each side
            return {"int64 draws": dict(sample_ids=ids),
                    "int32 draws": dict(sample_ids=ids.to(torch.int32)),
                    "generator": dict(
                        generator=torch.Generator().manual_seed(2))}[case]

        got = te.estimate_motion_many(flow, valid, calib_vec, warm, params,
                                      **draws())
        want = te.estimate_motion_many_plain(flow, valid, calib_vec, warm,
                                             params, **draws())
        for name, g, w in zip(te.MotionEstimate._fields, got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (case, name)
        assert got.success.all(), case
    # K = 1 through estimate_motion, a row-strided flow as the staged
    # pipeline hands it
    packed = torch.cat([flow[0], torch.ones(96, 1)], 1)
    one = te.estimate_motion(packed[:, :8], valid[0], calib_vec, warm[0],
                             params, sample_ids=ids[0])
    plain = te.estimate_motion_many_plain(
        flow[:1], valid[:1], calib_vec, warm[:1], params,
        sample_ids=ids[:1])
    assert torch.equal(one.tr, plain.tr[0])
    assert torch.equal(one.inliers, plain.inliers[0])
    assert te.launches == before


def _bad_args(case: str):
    flow, valid, calib_vec, warm = synthetic_flow(2, 32, seed=3)
    ids = torch.zeros(2, 5, 3, dtype=torch.int64)
    args = dict(flow=flow, valid=valid, calib_vec=calib_vec, initial_tr=warm,
                sample_ids=ids)
    if case == "flow_dtype":
        args["flow"] = flow.double()
    elif case == "flow_shape":
        args["flow"] = flow[..., :7]
    elif case == "valid_dtype":
        args["valid"] = valid.to(torch.uint8)
    elif case == "calib_shape":
        args["calib_vec"] = torch.zeros(3)
    elif case == "initial_tr_K":
        args["initial_tr"] = torch.zeros(3, 6)
    elif case == "valid_K":
        args["valid"] = torch.ones(1, 32, dtype=torch.bool)
    elif case == "sample_ids_K":
        args["sample_ids"] = torch.zeros(3, 5, 3, dtype=torch.int64)
    elif case == "sample_ids_dtype":
        args["sample_ids"] = ids.float()
    elif case == "flow_columns_strided":
        args["flow"] = flow.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "valid_non_contiguous":
        args["valid"] = torch.ones(2, 64, dtype=torch.bool)[:, ::2]
    elif case == "sample_ids_non_contiguous":
        args["sample_ids"] = torch.zeros(2, 3, 5,
                                         dtype=torch.int64).transpose(1, 2)
    return args


@pytest.mark.parametrize("case", [
    "flow_dtype", "flow_shape", "valid_dtype", "calib_shape", "initial_tr_K",
    "valid_K", "sample_ids_K", "sample_ids_dtype", "flow_columns_strided",
    "valid_non_contiguous", "sample_ids_non_contiguous",
])
def test_wrapper_rejects_bad_arguments_before_any_launch(case, monkeypatch):
    """Each argument fault the kernels cannot take raises ValueError in the
    wrapper, before the plain version runs or a kernel launches."""
    args = _bad_args(case)

    def plain(*a, **kw):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(te, "estimate_motion_many_plain", plain)
    before = te.launches
    with pytest.raises(ValueError, match="estimate_motion_many"):
        te.estimate_motion_many(args["flow"], args["valid"],
                                args["calib_vec"], args["initial_tr"], VO,
                                sample_ids=args["sample_ids"])
    assert te.launches == before


@pytest.mark.parametrize("shape, orders", [
    # visual odometry: one slot of 2048 matches, 500 hypotheses
    ((1, 500, 2048), (False, 128, 31)),
    # one object slot: the refinement's products split K
    ((1, 200, 256), (False, 32, 8)),
    # object batches: the hypotheses' J^T r by even and odd rows at
    # 1400-2800 hypotheses in all, else by two blocks
    ((6, 200, 256), (False, 1, 0)),
    ((7, 200, 256), (True, 1, 0)),
    ((14, 200, 256), (True, 1, 0)),
    ((16, 200, 256), (False, 1, 0)),
])
def test_reduction_orders_follow_the_measured_cublas_choices(shape, orders):
    """The summation orders the kernels reproduce (``csrc/egomotion.cu``'s
    note), at the shapes where cuBLAS's choices were measured on the
    card."""
    assert te.reduction_orders(*shape) == orders
