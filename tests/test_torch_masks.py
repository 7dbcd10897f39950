"""The silhouette cuts of the staged path (``ops/masks.py``:
``cut_out_instance``, ``remove_silhouette``) against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import torch

from dynslam_tpu.ops import masks as jm
from dynslam_tpu_torch.ops import masks as tm


def _view():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    depth = rng.uniform(0, 10, (20, 30)).astype(np.float32)
    copy = rng.random((20, 30)) < 0.3
    delete = copy | (rng.random((20, 30)) < 0.1)
    return rgb, depth, copy, delete


def test_cut_out_instance_matches_jax():
    args = _view()
    ref = jm.cut_out_instance(*map(jnp.asarray, args))
    got = tm.cut_out_instance(*map(torch.from_numpy, args))
    for a, b in zip(ref, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


def test_remove_silhouette_matches_jax():
    rgb, depth, _, delete = _view()
    ref = jm.remove_silhouette(*map(jnp.asarray, (rgb, depth, delete)))
    got = tm.remove_silhouette(*map(torch.from_numpy, (rgb, depth, delete)))
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())
