"""The port's frame reader and dump readers against the JAX package's, on
sequences each package wrote: ``Input`` (frames, depth from ELAS XML and
DispNet PFM dumps, a live nearest resize), ``PrecomputedSegmentationProvider``
and ``write_kitti_sequence``."""

import os

import numpy as np
import pytest

from dynslam_tpu.io import depth_providers as jdp
from dynslam_tpu.io import input as jin
from dynslam_tpu.io import segmentation as jseg
from dynslam_tpu.io.synthetic import write_kitti_sequence as jax_write
from dynslam_tpu_torch.config import StereoCalibration as TCalib
from dynslam_tpu_torch.io import depth_providers as tdp
from dynslam_tpu_torch.io import input as tin
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence as port_write

W, H, N = 96, 72, 3


@pytest.fixture(scope="module")
def jax_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jaxseq"))
    jax_write(root, num_frames=N, width=W, height=H, with_dynamic=True,
              write_dispnet=True)
    return root


@pytest.fixture(scope="module")
def port_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("portseq"))
    port_write(root, num_frames=N, width=W, height=H, with_dynamic=True,
               write_dispnet=True)
    return root


def _inputs(root, dispnet: bool, scale: float = 1.0, jax_side=None):
    """(JAX Input, port Input) over ``root``; ``jax_side`` reads both with
    the JAX package's classes when True."""
    calib = TCalib(0.5, 0.8 * W)
    size = (int(W / scale), int(H / scale))
    out = []
    for mod, dp in ((jin, jdp), (tin, tdp)):
        if jax_side:
            mod, dp = jin, jdp
        icfg = mod.kitti_odometry_dispnet_config() if dispnet \
            else mod.kitti_odometry_config()
        prov = dp.PrecomputedDepthProvider(
            os.path.join(root, icfg.depth_folder), icfg.depth_fname_format,
            input_is_depth=icfg.read_depth)
        out.append(mod.Input(root, icfg, prov, size, calib,
                             input_scale=scale))
    return out


@pytest.mark.parametrize("dispnet", [False, True], ids=["elas-xml", "pfm"])
def test_input_reads_jax_sequence_equal(jax_seq, dispnet):
    ji, ti = _inputs(jax_seq, dispnet)
    n = 0
    while ji.has_more_images():
        assert ti.has_more_images()
        ji.read_next_frame()
        ti.read_next_frame()
        for a, b in zip(ji.get_images() + ji.get_stereo_color(),
                        ti.get_images() + ti.get_stereo_color()):
            assert a.dtype == b.dtype and np.array_equal(a, b), n
        n += 1
    assert n == N and not ti.has_more_images()
    assert ti.get_dataset_identifier() == ji.get_dataset_identifier()
    for f in (2, 0):  # delayed evaluation's random access
        for a, b in zip(ji.get_frame_images(f), ti.get_frame_images(f)):
            assert np.array_equal(a, b), f


def test_input_live_resize_equal(jax_seq):
    """A 1.5x live downscale (cv2 INTER_NEAREST in the JAX package)."""
    ji, ti = _inputs(jax_seq, dispnet=True, scale=1.5)
    for f in range(N):
        for a, b in ((ji.read_left_color(f), ti.read_left_color(f)),
                     (ji.read_right_color(f), ti.read_right_color(f))):
            assert a.shape == (H / 1.5, W / 1.5, 3) and np.array_equal(a, b)


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_segmentation_dumps_equal(jax_seq, scale):
    jp = jseg.PrecomputedSegmentationProvider(
        os.path.join(jax_seq, "seg_image_2/mnc"), input_scale=scale,
        min_detection_size_px=8)
    tp = tseg.PrecomputedSegmentationProvider(
        os.path.join(jax_seq, "seg_image_2/mnc"), input_scale=scale,
        min_detection_size_px=8)
    total = 0
    for f in range(N):
        jd = jp.segment_frame(None).instance_detections
        td = tp.segment_frame(None).instance_detections
        assert len(jd) == len(td), f
        for a, b in zip(jd, td):
            assert (a.class_id, a.class_probability) == (b.class_id,
                                                         b.class_probability)
            for m in ("copy_mask", "delete_mask", "conservative_mask"):
                ma, mb = getattr(a, m), getattr(b, m)
                assert vars(ma.bbox) == vars(mb.bbox), (f, m)
                assert np.array_equal(ma.data, mb.data), (f, m)
        total += len(td)
    assert total >= N - 1


def test_port_sequence_reads_equal_in_jax(jax_seq, port_seq):
    """The port's writer gives a folder the JAX package reads equal to its
    own: frames, ELAS and PFM depth, segmentation dumps, calibration,
    poses and LIDAR."""
    for dispnet in (False, True):
        ja, _ = _inputs(jax_seq, dispnet, jax_side=True)
        pa, _ = _inputs(port_seq, dispnet, jax_side=True)
        while ja.has_more_images():
            ja.read_next_frame()
            pa.read_next_frame()
            for a, b in zip(ja.get_images() + ja.get_stereo_color(),
                            pa.get_images() + pa.get_stereo_color()):
                assert np.array_equal(a, b)
    for name in ("calib.txt", "ground-truth-poses.txt", "tracklets.txt"):
        assert open(os.path.join(port_seq, name)).read() == open(
            os.path.join(jax_seq, name)).read(), name
    for f in range(N):
        for sub in (f"velodyne/{f:06d}.bin",):
            assert open(os.path.join(port_seq, sub), "rb").read() == open(
                os.path.join(jax_seq, sub), "rb").read()
    seg = sorted(os.listdir(os.path.join(jax_seq, "seg_image_2/mnc")))
    assert sorted(os.listdir(os.path.join(port_seq, "seg_image_2/mnc"))) \
        == seg
    for name in seg:
        assert open(os.path.join(port_seq, "seg_image_2/mnc", name)).read() \
            == open(os.path.join(jax_seq, "seg_image_2/mnc", name)).read()


def test_stereo_matcher_provider_equal():
    """The live census provider against the JAX package's."""
    from dynslam_tpu.config import StereoMatcherParams as JP
    from dynslam_tpu_torch.config import StereoMatcherParams as TP

    rng = np.random.default_rng(5)
    left = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    calib = TCalib(0.5, 0.8 * W)
    a = jdp.StereoMatcherDepthProvider(JP(max_disparity=16)) \
        .depth_from_stereo(left, right, calib)
    b = tdp.StereoMatcherDepthProvider(TP(max_disparity=16), device="cpu") \
        .depth_from_stereo(left, right, calib)
    assert a.dtype == b.dtype == np.int16
    assert (a == b).mean() >= 0.999 and (a > 0).mean() > 0.2
