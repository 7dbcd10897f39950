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


def tie_heavy_pair(h=96, w=192, shift=11, seed=5):
    """Flat patches of a few grey levels, a band of period-8 stripes and a
    checkerboard band (integer costs tie across many disparities there),
    the right image the left one shifted by ``shift`` columns."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(25):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(4, 30), x:x + rng.integers(4, 60)] = \
            rng.choice([0.0, 64.0, 128.0, 192.0, 255.0])
    img[h // 3:h // 3 + 12] = ((np.arange(w) // 4) % 2) * 200.0
    img[2 * h // 3:2 * h // 3 + 10] = ((np.arange(w)[None] // 3
                                        + np.arange(10)[:, None] // 3)
                                       % 2) * 100.0
    return img, np.roll(img, -shift, axis=1)


@pytest.mark.parametrize("params", [
    StereoMatcherParams(max_disparity=64),
    StereoMatcherParams(max_disparity=64, subpixel=False),
], ids=["default", "no_median"])
def test_stereo_matches_jax_on_ties(params):
    """Flat patches and repeated textures, where many disparities cost the
    same: both argmins keep the first minimum, so the winners are exact
    and the runner-up and neighbour costs are the same integers."""
    lg, rg = tie_heavy_pair()
    ref = np.asarray(js.compute_disparity_jit(jnp.asarray(lg),
                                              jnp.asarray(rg), params))
    got = ts.compute_disparity_plain(torch.tensor(lg), torch.tensor(rg),
                                     params).numpy()
    assert np.array_equal(np.floor(ref + 0.5), np.floor(got + 0.5))
    assert (np.abs(ref - got) <= 1e-4).mean() >= 0.999
    assert (ref > 0).mean() > 0.2


@pytest.mark.parametrize("params", [
    StereoMatcherParams(max_disparity=64),
    StereoMatcherParams(max_disparity=64, subpixel=False),
    StereoMatcherParams(max_disparity=48, fill_gaps=8),
], ids=["default", "no_median", "fill_gaps"])
def test_cpu_tensors_take_the_plain_version(frames, params):
    """The wrapper hands CPU tensors to ``compute_disparity_plain`` and
    returns what it returns, bit for bit, and launches nothing; so does
    ``depth_m_from_stereo`` with ``ops/depth.py``'s conversion."""
    from dynslam_tpu_torch.ops import depth as td

    (lg, rg), _ = frames[0]
    left, right = torch.tensor(lg), torch.tensor(rg)
    before = ts.launches
    got = ts.compute_disparity(left, right, params)
    want = ts.compute_disparity_plain(left, right, params)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    depth = ts.depth_m_from_stereo(left, right, params, 80.0, 0.5, 20.0)
    assert torch.equal(depth, td.depth_m_from_mm(td.depth_mm_from_disparity(
        want, 80.0, 0.5, 20.0)))
    assert (depth > 0).mean(dtype=torch.float32) > 0.3
    assert ts.launches == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_census_radius_above_3_raises_as_the_plain_version(device):
    """A census window of more than 63 bits: the plain version raises, and
    the wrapper raises the same before it looks at the device."""
    params = StereoMatcherParams(max_disparity=8, census_radius=4)
    left = torch.zeros(16, 32)
    with pytest.raises(ValueError, match="census window too large"):
        ts.compute_disparity_plain(left, left, params)
    left = left.to(device)
    before = ts.launches
    with pytest.raises(ValueError, match="census window too large"):
        ts.compute_disparity(left, left, params)
    with pytest.raises(ValueError, match="census window too large"):
        ts.depth_m_from_stereo(left, left, params, 80.0, 0.5, 20.0)
    assert ts.launches == before


def _bad_images(case: str):
    left = torch.rand(16, 40) * 255
    right = torch.rand(16, 40) * 255
    params = StereoMatcherParams(max_disparity=16)
    if case == "dtype":
        left, right = left.double(), right.double()
    elif case == "rank":
        left, right = left[None], right[None]
    elif case == "shapes":
        right = right[:, :32]
    elif case == "strided":
        left = torch.rand(40, 16).t()
    elif case == "devices":
        right = right.to("meta")
    elif case == "empty":
        left, right = left[:0], right[:0]
    elif case == "disparity_above_width":
        params = StereoMatcherParams(max_disparity=41)
    elif case == "no_disparity":
        params = StereoMatcherParams(max_disparity=0)
    elif case == "negative_radius":
        params = StereoMatcherParams(max_disparity=16, aggregation_radius=-1)
    return left, right, params


@pytest.mark.parametrize("case", [
    "dtype", "rank", "shapes", "strided", "devices", "empty",
    "disparity_above_width", "no_disparity", "negative_radius",
])
def test_wrapper_rejects_bad_arguments_before_any_launch(case, monkeypatch):
    """Each fault the kernels cannot take raises ValueError in the wrapper,
    before the plain version runs or a kernel launches."""
    left, right, params = _bad_images(case)

    def plain(*a, **kw):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ts, "compute_disparity_plain", plain)
    before = ts.launches
    with pytest.raises(ValueError, match="compute_disparity"):
        ts.compute_disparity(left, right, params)
    with pytest.raises(ValueError, match="compute_disparity"):
        ts.depth_m_from_stereo(left, right, params, 80.0, 0.5, 20.0)
    assert ts.launches == before
