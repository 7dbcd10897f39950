"""SegNet-lite's provider and files (``dynslam_tpu_torch/models/segnet.py``,
``utils/msgpack.py``, ``io/images.connected_components``) against the
JAX package and ``cv2``.

- msgpack: the port's bytes equal ``flax.serialization``'s for the same
  tree, and params files written by either package load in the other
  (arrays equal).
- connected components: equal to ``cv2.connectedComponentsWithStats``
  label for label and stat for stat on random masks.
- a SegNet trained by the port (60 Adam steps, as tests/test_segnet.py
  trains the JAX one) detects the synthetic car; the JAX provider on the
  same weights and frame gives the same detections: equal boxes and
  classes, >= 99.9% of the mask pixels equal, scores within 1e-5 (the
  probabilities agree to ~1e-7, so a pixel at the threshold could flip).
"""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dynslam_tpu.models import segnet as js
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.config import Intrinsics, StereoCalibration
from dynslam_tpu_torch.io.images import connected_components
from dynslam_tpu_torch.io.synthetic import (
    SyntheticScene, render_stereo_frame, straight_trajectory,
)
from dynslam_tpu_torch.models import segnet as ts
from dynslam_tpu_torch.utils import msgpack
from torch_threads import threads

torch_threads = threads(1)

W, H = 96, 64
INTR = Intrinsics(0.8 * W, 0.8 * W, W / 2, H / 2)
CALIB = StereoCalibration(0.5, INTR.fx)
MIN_MASK_AGREE, SCORE_ATOL = 0.999, 1e-5


def _frame(scene, poses, f):
    fr = render_stereo_frame(scene, poses[f], INTR, CALIB, W, H, frame=f)
    g = np.clip(fr["left_gray"] * 255, 0, 255)
    dyn_ids = [i + 1 for i, b in enumerate(scene.boxes) if b.is_dynamic]
    return np.stack([g] * 3, -1), np.isin(fr["object_id"], dyn_ids)


@pytest.fixture(scope="module")
def trained():
    """tests/test_segnet.py's training, in the port: 60 Adam steps (lr
    3e-3) on frames (it % 8, (it + 3) % 8) of a synthetic scene."""
    scene = SyntheticScene.default_scene(seed=4, with_dynamic=True)
    poses = straight_trajectory(8, speed=0.2)
    frames = [_frame(scene, poses, f) for f in range(8)]
    model = ts.init_params(ts.create_model(), torch.Generator().manual_seed(0))
    step = ts.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=3e-3))
    losses = []
    for it in range(60):
        pick = [frames[it % 8], frames[(it + 3) % 8]]
        batch = {"rgb": torch.tensor(np.stack([p[0] for p in pick]),
                                     dtype=torch.float32).permute(0, 3, 1, 2),
                 "mask": torch.tensor(np.stack([p[1] for p in pick]))}
        losses.append(float(step(batch)))
    return model, scene, poses, losses


def test_msgpack_bytes_equal_flax():
    """Every kind of value Flax writes: nested maps, numpy arrays of
    several dtypes and shapes (0-d included, ext8/16/32 and fixext
    payloads), numpy scalars, Python ints of every width, floats, str of
    every header, bytes, lists, None and bools."""
    rng = np.random.default_rng(0)
    tree = {
        "params": {f"Conv_{i}": {"kernel": rng.standard_normal(
            (3, 3, 2, i + 1)).astype(np.float32),
            "bias": np.zeros(i + 1, np.float32)} for i in range(17)},
        "arrays": [np.arange(n).astype(d) for n, d in (
            (0, np.uint8), (1, np.int8), (3, np.int32), (5, np.float64),
            (70000, np.uint8), (4, np.bool_), (2, np.float16))],
        "zero_d": np.array(3.5, np.float32),
        "scalars": [np.float32(1.25), np.int64(-7), np.uint8(200)],
        "ints": [0, 5, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31, -2 ** 31 - 1],
        "floats": [0.0, -1.5, 1e300],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                 "e" * 70000, "ü"],
        "bytes": [b"", b"x" * 300, b"y" * 70000],
        "misc": [None, True, False, [[], [1, [2]]]],
    }
    # what ``serialization.to_bytes`` does with a state dict: serialise it
    # in place, in its own key order (a copy would sort the keys)
    ref = serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    assert msgpack.to_bytes(tree) == ref
    back = msgpack.from_bytes(ref)
    assert back.keys() == tree.keys()
    np.testing.assert_array_equal(back["params"]["Conv_9"]["kernel"],
                                  tree["params"]["Conv_9"]["kernel"])
    for a, b in zip(back["arrays"], tree["arrays"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert back["zero_d"].shape == () and back["zero_d"] == 3.5
    assert back["scalars"] == [1.25, -7, 200]
    assert isinstance(back["scalars"][0], np.float32)
    for k in ("ints", "floats", "strs", "bytes", "misc"):
        assert back[k] == tree[k], k


def test_params_files_cross_packages(tmp_path, trained):
    """The port's ``save_params`` file equals Flax's bytes for the same
    weights and loads in the JAX package; JAX's file loads in the port."""
    model = trained[0]
    flax_tree = convert.state_dict_to_flax(model.state_dict())
    mine = tmp_path / "port.msgpack"
    ts.save_params(str(mine), model)
    assert mine.read_bytes() == serialization.to_bytes(flax_tree)
    # js.load_params' own path: from_bytes into Flax's init tree (its
    # shapes by eval_shape; the eager init itself compiles op by op)
    template = jax.eval_shape(js.create_model().init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 24, 3), jnp.float32))
    jparams = serialization.from_bytes(template, mine.read_bytes())
    for name, p in flax_tree["params"].items():
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(jparams["params"][name][k]),
                                          v)
    theirs = tmp_path / "jax.msgpack"
    js.save_params(str(theirs), jax.tree_util.tree_map(jnp.asarray,
                                                       flax_tree))
    back = ts.load_params(str(theirs), ts.create_model())
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    with pytest.raises(ValueError, match="do not fit"):
        ts.load_params(str(theirs), ts.SegNetLite(features=(8, 16, 32)))


@pytest.mark.parametrize("seed", range(4))
def test_connected_components_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        h, w = rng.integers(1, 80, 2)
        m = (rng.random((h, w)) < rng.uniform(0.02, 0.9)).astype(np.uint8)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(m)
        n2, labels2, stats2 = connected_components(m)
        assert n2 == n
        np.testing.assert_array_equal(labels2, labels)
        np.testing.assert_array_equal(stats2, stats)


def test_connected_components_edge_cases():
    """All background, all foreground (OpenCV's empty background row), one
    pixel, and two components whose first pixels' raster order differs
    from their first 2x2 blocks' (OpenCV labels by the blocks)."""
    m = np.zeros((4, 8), np.uint8)
    m[1, 0] = m[0, 5] = 1
    for case in (np.zeros((3, 5), np.uint8), np.ones((3, 5), np.uint8),
                 np.ones((1, 1), np.uint8), m):
        n, labels, stats, _ = cv2.connectedComponentsWithStats(case)
        n2, labels2, stats2 = connected_components(case)
        assert n2 == n
        np.testing.assert_array_equal(labels2, labels)
        np.testing.assert_array_equal(stats2, stats)
    assert connected_components(m)[1][1, 0] == 1


def test_trained_provider_detects_car(trained):
    """tests/test_segnet.py's check on the port's model and provider."""
    model, scene, poses, losses = trained
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    prov = ts.LearnedSegmentationProvider(model, min_detection_size_px=6)
    rgb, gt = _frame(scene, poses, 2)
    result = prov.segment_frame(rgb.astype(np.uint8))
    assert len(result.instance_detections) >= 1
    det = max(result.instance_detections,
              key=lambda d: d.copy_mask.bbox.area)
    assert det.class_name == "car"
    pred = det.copy_mask.to_full_frame(H, W)
    assert (gt & pred).sum() / max(gt.sum(), 1) > 0.5
    assert prov.get_seg_preview() is not None


@pytest.mark.parametrize("frame", [2, 5])
def test_providers_agree(trained, frame):
    """The JAX provider on the same weights and frame: the same raw
    detections and the same InstanceDetection masks."""
    model, scene, poses, _ = trained
    rgb = _frame(scene, poses, frame)[0].astype(np.uint8)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, convert.state_dict_to_flax(model.state_dict()))
    jprov = js.LearnedSegmentationProvider(js.create_model(), jparams,
                                           min_detection_size_px=6)
    tprov = ts.LearnedSegmentationProvider(model, min_detection_size_px=6)
    want, got = jprov.raw_detections(rgb), tprov.raw_detections(rgb)
    assert len(got) == len(want) >= 1
    for (gb, gs, gc, gm), (wb, ws, wc, wm) in zip(got, want):
        assert (gb.x0, gb.y0, gb.x1, gb.y1) == (wb.x0, wb.y0, wb.x1, wb.y1)
        assert gc == wc == 7
        assert gs == pytest.approx(ws, abs=SCORE_ATOL)
        assert (gm == wm).mean() >= MIN_MASK_AGREE
    np.testing.assert_allclose(tprov._last_prob, jprov._last_prob,
                               atol=1e-6)
    jres, tres = jprov.segment_frame(rgb), tprov.segment_frame(rgb)
    for a, b in zip(tres.instance_detections, jres.instance_detections):
        for k in ("copy_mask", "delete_mask", "conservative_mask"):
            ma, mb = getattr(a, k), getattr(b, k)
            assert (ma.bbox.x0, ma.bbox.y0, ma.bbox.x1, ma.bbox.y1) == (
                mb.bbox.x0, mb.bbox.y0, mb.bbox.x1, mb.bbox.y1)
            assert (ma.data == mb.data).mean() >= MIN_MASK_AGREE
