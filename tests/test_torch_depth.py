"""Depth conversions: the port's ``ops/depth.py`` against the JAX
package's ``ops/depth.py`` on the same disparities and images."""

import jax.numpy as jnp
import numpy as np
import torch

from dynslam_tpu.ops import depth as jd
from dynslam_tpu_torch.ops import depth as td

torch.set_num_threads(2)

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
