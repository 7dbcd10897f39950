"""SE(3) helpers: the port's ``utils/se3.py`` (batched) against the JAX
package's ``utils/se3.py`` (one transform at a time) on the same twists."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.utils import se3 as js
from dynslam_tpu_torch.utils import se3 as ts
from torch_threads import threads

torch_threads = threads(2)


@pytest.fixture(scope="module")
def twists():
    rng = np.random.default_rng(0)
    xi = rng.normal(0.0, 0.3, (16, 6)).astype(np.float32)
    xi[0, :3] = 0.0  # identity rotation
    xi[1, :3] = 1e-8  # small-angle branch
    return xi


@pytest.mark.parametrize("name", ["hat", "so3_exp", "exp_se3"])
def test_twist_maps_match_jax(twists, name):
    arg = twists[:, :3] if name in ("hat", "so3_exp") else twists
    ref = np.asarray(jax.vmap(getattr(js, name))(jnp.asarray(arg)))
    got = getattr(ts, name)(torch.from_numpy(arg)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_viso2_twist_and_inverse_match_jax(twists):
    T_ref = np.asarray(jax.vmap(js.twist_to_transform)(jnp.asarray(twists)))
    T = ts.twist_to_transform(torch.from_numpy(twists))
    np.testing.assert_allclose(T.numpy(), T_ref, rtol=0, atol=2e-6)
    inv_ref = np.asarray(jax.vmap(js.inverse)(jnp.asarray(T_ref)))
    np.testing.assert_allclose(ts.inverse(T).numpy(), inv_ref, rtol=0,
                               atol=2e-6)
    eye = (ts.inverse(T) @ T).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                               atol=2e-6)
    ang_ref = np.asarray(jax.vmap(js.rotation_angle)(jnp.asarray(
        T_ref[:, :3, :3])))
    np.testing.assert_allclose(ts.rotation_angle(T[:, :3, :3]).numpy(),
                               ang_ref, atol=1e-3)
