"""Feature detection, circular matching and LK refinement: the port
against ``dynslam_tpu/ops/features.py`` on the same frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.ops import features as jf
from dynslam_tpu_torch.ops import features as tf

from torch_frontend_inputs import VO, make_frames
from torch_threads import threads

torch_threads = threads(2)


@pytest.fixture(scope="module")
def frames():
    return make_frames()


def _features_both(frames):
    J = [jf.detect_features_pair(jnp.asarray(l), jnp.asarray(r), VO)
         for (l, r) in frames]
    T = [tf.detect_features_pair(torch.tensor(l), torch.tensor(r), VO)
         for (l, r) in frames]
    return J, T


def test_features_match_jax(frames):
    J, T = _features_both(frames[0])
    for pair_j, pair_t in zip(J, T):
        for fj, ft in zip(pair_j, pair_t):
            vj, vt = np.asarray(fj.valid), ft.valid.numpy()
            assert np.array_equal(vj, vt)
            assert vj.sum() > 200
            assert np.abs(np.asarray(fj.pos)[vj]
                          - ft.pos.numpy()[vt]).max() <= 1e-4
            assert np.allclose(np.asarray(fj.desc), ft.desc.numpy())
            assert np.array_equal(np.asarray(fj.cls), ft.cls.numpy())


def test_top_k_stable_breaks_ties_by_index():
    vals, idx = tf.top_k_stable(torch.tensor([1.0, 2, 2, 2, 0]), 2)
    assert idx.tolist() == [1, 2] and vals.tolist() == [2.0, 2.0]


def test_matching_and_refinement_match_jax(frames):
    fr, _ = frames
    J, T = _features_both(fr)
    fj, vj = jf.circular_match(J[1][0], J[1][1], J[0][0], J[0][1], VO)
    ft, vt = tf.circular_match(T[1][0], T[1][1], T[0][0], T[0][1], VO)
    assert np.array_equal(np.asarray(vj), vt.numpy())
    assert vt.sum() > 100
    assert np.abs(np.asarray(fj) - ft.numpy()).max() <= 1e-4

    imgs = (fr[1][0], fr[1][1], fr[0][0], fr[0][1])
    rj = np.asarray(jf.refine_flow_quad(*map(jnp.asarray, imgs), fj))
    rt = tf.refine_flow_quad(*map(torch.tensor, imgs), ft).numpy()
    m = np.asarray(vj)
    assert np.abs(rj[m] - rt[m]).max() <= 1e-3
