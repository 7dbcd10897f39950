"""The port's segmentation model (``dynslam_tpu_torch/io/segmentation.py``)
against the JAX package's: detections from the same object ids are equal
mask for mask, and the numpy ``Mask.rescale`` reproduces ``cv2.resize``'s
uint8 bilinear rule byte for byte."""

import cv2
import numpy as np
import pytest

from dynslam_tpu.config import Intrinsics
from dynslam_tpu.io import segmentation as jseg
from dynslam_tpu.io.synthetic import SyntheticScene, render_frame
from dynslam_tpu_torch.io import segmentation as tseg

W, H = 160, 120


def _masks_equal(a, b):
    assert (a.bbox.x0, a.bbox.y0, a.bbox.x1, a.bbox.y1) == \
        (b.bbox.x0, b.bbox.y0, b.bbox.x1, b.bbox.y1)
    assert a.data.dtype == b.data.dtype == np.uint8
    assert np.array_equal(a.data, b.data)


@pytest.mark.parametrize("frame", [0, 3])
def test_detections_match_jax(frame):
    """The object ids of ``default_scene(with_dynamic=True)`` at 160x120
    (the car, and the buildings as further instances): every detection's
    copy, delete and conservative masks equal, bbox and data."""
    scene = SyntheticScene.default_scene(with_dynamic=True)
    pose = np.eye(4)
    pose[2, 3] = 0.35 * frame
    fr = render_frame(scene, pose, Intrinsics(128.0, 128.0, W / 2, H / 2),
                      W, H, frame=frame, supersample=1)
    # instances whose 0.97x conservative mask keeps a pixel on each side
    # (OpenCV refuses an empty resize)
    objid = fr["object_id"].copy()
    for oid in np.unique(objid[objid > 0]):
        ys, xs = np.nonzero(objid == oid)
        if xs.max() - xs.min() < 3 or ys.max() - ys.min() < 3:
            objid[objid == oid] = 0
    for min_px in (8, 45):
        jd = jseg.detections_from_instance_ids(objid, min_size_px=min_px,
                                               score=0.98)
        td = tseg.detections_from_instance_ids(objid, min_size_px=min_px,
                                               score=0.98)
        assert len(td) == len(jd) >= 3
        for a, b in zip(jd, td):
            assert (a.class_id, a.class_probability) == \
                (b.class_id, b.class_probability)
            assert a.is_reconstructable() == b.is_reconstructable()
            for m in ("copy_mask", "delete_mask", "conservative_mask"):
                _masks_equal(getattr(a, m), getattr(b, m))
                assert np.array_equal(getattr(a, m).to_full_frame(H, W),
                                      getattr(b, m).to_full_frame(H, W))


@pytest.mark.parametrize("scale", [0.97, 1.0, 1.2, 1.44])
def test_rescale_matches_cv2(scale):
    """Seeded random binary masks, and random uint8 images, of many sizes:
    ``Mask.rescale`` equals ``cv2.resize(INTER_LINEAR)`` exactly."""
    rng = np.random.default_rng(int(scale * 100))
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(1, 80, 2))
        nw, nh = int(w * scale), int(h * scale)
        if nw < 1 or nh < 1:
            continue
        data = (rng.random((h, w)) < rng.uniform(0.2, 0.8)).astype(np.uint8)
        bbox = tseg.BoundingBox(5, 7, 5 + w - 1, 7 + h - 1)
        m = tseg.Mask(bbox, data)
        m.rescale(scale)
        want = cv2.resize(data, (nw, nh), interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(m.data, want.reshape(nh, nw)), (h, w)
        jm = jseg.Mask(jseg.BoundingBox(5, 7, 5 + w - 1, 7 + h - 1), data)
        jm.rescale(scale)
        _masks_equal(jm, m)
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        got = tseg._resize_linear_u8(img, nw, nh)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(got, want.reshape(nh, nw)), (h, w)


def test_box_helpers_match_jax():
    a, b = tseg.BoundingBox(0, 0, 9, 9), tseg.BoundingBox(5, 5, 14, 19)
    ja, jb = jseg.BoundingBox(0, 0, 9, 9), jseg.BoundingBox(5, 5, 14, 19)
    assert a.iou(b) == ja.iou(jb)
    assert a.intersect(tseg.BoundingBox(20, 20, 30, 30)) is None
    assert tseg.PASCAL_VOC_2012_CLASSES == jseg.PASCAL_VOC_2012_CLASSES
    assert tseg.CLASSES_TO_RECONSTRUCT == jseg.CLASSES_TO_RECONSTRUCT
    assert tseg.POSSIBLY_DYNAMIC_CLASSES == jseg.POSSIBLY_DYNAMIC_CLASSES
