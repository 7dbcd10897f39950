"""Depth conversions: the port's ``ops/depth.py`` against the JAX
package's ``ops/depth.py`` on the same disparities and images."""

import jax.numpy as jnp
import numpy as np
import torch

from dynslam_tpu.ops import depth as jd
from dynslam_tpu_torch.ops import depth as td
from torch_threads import threads

torch_threads = threads(2)

BF = 0.537150654273 * 707.0912


def test_depth_from_disparity_matches_jax():
    rng = np.random.default_rng(0)
    disp = np.concatenate([
        rng.uniform(0.0, 130.0, 4000),
        [0.0, 1e-6, -1e-6, -3.0, 0.5, 18.99, 19.0, 760.0, 1e30],
    ]).astype(np.float32).reshape(-1, 1)
    mm_ref = np.asarray(jd.depth_mm_from_disparity(jnp.asarray(disp), BF))
    mm = td.depth_mm_from_disparity(torch.from_numpy(disp), BF)
    assert mm.dtype == torch.int16
    assert np.array_equal(mm.numpy(), mm_ref)
    assert (mm_ref == 0).any() and (mm_ref > 0).mean() > 0.8
    m_ref = np.asarray(jd.depth_m_from_mm(jnp.asarray(mm_ref)))
    np.testing.assert_array_equal(td.depth_m_from_mm(mm).numpy(), m_ref)


def test_rgb_to_gray_matches_jax():
    rgb = np.random.default_rng(1).integers(0, 256, (16, 24, 3),
                                            dtype=np.uint8)
    ref = np.asarray(jd.rgb_to_gray(jnp.asarray(rgb)))
    assert np.array_equal(td.rgb_to_gray(torch.from_numpy(rgb)).numpy(), ref)


def test_disparity_from_depth_matches_jax():
    d = np.concatenate([np.random.default_rng(2).uniform(0.3, 30.0, 500),
                        [0.0, -1.0, 1e-7, 2e-6]]).astype(np.float32)
    ref = np.asarray(jd.disparity_from_depth_m(jnp.asarray(d), BF))
    np.testing.assert_allclose(
        td.disparity_from_depth_m(torch.from_numpy(d), BF).numpy(), ref,
        rtol=1e-6)


def test_bilateral_filter_matches_jax():
    """A smooth depth map with a step, holes and noise: the edge stays and
    the holes stay empty. XLA contracts the weighted sums into fused
    multiply-adds and its exp differs from PyTorch's in the last bit, so the
    five passes agree to 1e-5 m (measured 3.8e-6 m, 8 ulps at 7 m), not bit
    for bit."""
    rng = np.random.default_rng(3)
    d = np.full((24, 32), 5.0, np.float32)
    d[:, 16:] = 7.0
    d += rng.normal(0, 0.01, d.shape).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0.0
    ref = np.asarray(jd.bilateral_filter_depth(jnp.asarray(d)))
    got = td.bilateral_filter_depth(torch.from_numpy(d)).numpy()
    assert np.array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    left = got[:, :14]
    assert np.abs(left[left > 0] - 5.0).max() < 0.03  # the step survives
