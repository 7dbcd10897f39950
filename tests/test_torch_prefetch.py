"""The prefetching reader (``io/prefetch.py``): the frames it hands out are
the plain ``Input``'s, a seek (a resumed run's ``frame_idx``) reads from
there, and the CLI's outputs with ``--prefetch`` equal the same run's
without it, byte for byte (trajectory, CSVs, previews, meshes, the
checkpoint's arrays), on the staged path and on the fused path."""

import filecmp
import os

import numpy as np
import pytest

from dynslam_tpu_torch import main
from dynslam_tpu_torch.config import StereoCalibration
from dynslam_tpu_torch.io.depth_providers import PrecomputedDepthProvider
from dynslam_tpu_torch.io.input import Input, kitti_odometry_config
from dynslam_tpu_torch.io.prefetch import PrefetchingInput
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence
from torch_threads import threads

torch_threads = threads(2)

W, H, N = 160, 120, 4


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prefetch"))
    write_kitti_sequence(root, num_frames=N, width=W, height=H,
                         with_dynamic=True)
    return root


def _input(root):
    icfg = kitti_odometry_config()
    return Input(root, icfg, PrecomputedDepthProvider(
        os.path.join(root, icfg.depth_folder), icfg.depth_fname_format,
        input_is_depth=True), (W, H), StereoCalibration())


def _frames(inp, n):
    out = []
    for _ in range(n):
        assert inp.has_more_images() and inp.read_next_frame()
        out.append((*inp.get_stereo_color(), inp.get_images()[1]))
    return out


def test_frames_equal_and_seek(seq):
    plain = _frames(_input(seq), N)
    pre = PrefetchingInput(_input(seq), prefetch_seg_folder=os.path.join(
        seq, "seg_image_2/mnc"))
    got = _frames(pre, N)
    assert not pre.has_more_images() and pre.frame_idx == N
    pre.frame_idx = 1  # a resumed run's seek
    got += _frames(pre, N - 1)
    pre.close()
    for want, have in zip(plain + plain[1:], got):
        for a, b in zip(want, have):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pre.get_dataset_identifier() == \
        _input(seq).get_dataset_identifier()


def _cli(seq, out, extra):
    assert main.main(["--dataset_root", seq, "--cpu", "--tiny",
                      "--min_detection_size", "8", "--out", str(out),
                      *extra]) == 0


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        elif name.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert np.array_equal(za[k], zb[k]), (name, k)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_cli_outputs_identical(seq, tmp_path, path):
    extra = ["--enable_evaluation", "--dump_previews_every", "2",
             "--save_mesh", "--frame_limit", "3",
             "--checkpoint_out", "ck.npz"]
    if path == "fused":
        extra += ["--fused", "--max_depth", "8"]
    else:
        extra += ["--evaluation_delay", "1"]
    runs = []
    for tag in ("plain", "prefetch"):
        out = tmp_path / tag
        out.mkdir()
        args = [a if a != "ck.npz" else str(out / "ck.npz") for a in extra]
        _cli(seq, out, args + (["--prefetch"] if tag == "prefetch" else []))
        runs.append(out)
    _same_tree(*runs)
    assert (runs[1] / "static_map.obj").exists()


def test_resumed_run_identical(seq, tmp_path):
    """A run resumed from a checkpoint with ``--prefetch`` (the reader
    seeks to the checkpoint's frame) writes what one without it writes."""
    ck = str(tmp_path / "ck.npz")
    _cli(seq, tmp_path / "first", ["--no-dynamic_mode", "--frame_limit",
                                   "2", "--checkpoint_out", ck])
    outs = []
    for tag in ("plain", "prefetch"):
        out = tmp_path / tag
        _cli(seq, out, ["--no-dynamic_mode", "--resume_from", ck,
                        "--dump_previews_every", "1"]
             + (["--prefetch"] if tag == "prefetch" else []))
        outs.append(out)
    _same_tree(*outs)
    assert (outs[1] / "frame000003_color.png").exists()
