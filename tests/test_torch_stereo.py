"""Census stereo: the port against ``dynslam_tpu/ops/stereo.py`` on the
same frames; integer winners are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.config import StereoMatcherParams
from dynslam_tpu.ops import stereo as js
from dynslam_tpu_torch.ops import stereo as ts

from torch_frontend_inputs import make_frames
from torch_threads import threads

torch_threads = threads(2)


@pytest.fixture(scope="module")
def frames():
    return make_frames()


@pytest.mark.parametrize("params", [
    StereoMatcherParams(max_disparity=64),
    StereoMatcherParams(max_disparity=48, fill_gaps=8),
    StereoMatcherParams(max_disparity=64, subpixel=False),
], ids=["default", "fill_gaps", "no_median"])
def test_stereo_matches_jax(frames, params):
    (lg, rg), _ = frames[0]
    ref = np.asarray(js.compute_disparity_jit(jnp.asarray(lg),
                                              jnp.asarray(rg), params))
    got = ts.compute_disparity(torch.tensor(lg), torch.tensor(rg),
                               params).numpy()
    # integer disparities (the winners) are exact
    assert np.array_equal(np.floor(ref + 0.5), np.floor(got + 0.5))
    assert (np.abs(ref - got) <= 1e-4).mean() >= 0.999
    assert (ref > 0).mean() > 0.4


def test_census_and_popcount(frames):
    (lg, _), _ = frames[0]
    lanes = np.asarray(js.census_transform(jnp.asarray(lg), 3)).astype(
        np.int64) & 0xFFFFFFFF
    sig = ts.census_transform(torch.tensor(lg), 3).numpy()
    assert np.array_equal(lanes[0] | (lanes[1] << 32), sig)
    x = np.random.default_rng(0).integers(0, 1 << 62, 1000, dtype=np.int64)
    want = [bin(int(v)).count("1") for v in x]
    assert ts.popcount64(torch.tensor(x)).tolist() == want
