"""``dynslam_tpu_torch.main`` end to end on the CPU (``--cpu --tiny``)
over a folder the port's ``write_kitti_sequence`` wrote: the staged path
with evaluation, previews and a checkpoint, its resume, and the fused
steps (``--fused``, static and dynamic); flags of later slices fail
loudly with their ROADMAP item."""

import os

import numpy as np
import pytest
import torch

from dynslam_tpu_torch import main
from dynslam_tpu_torch.io.calib import read_kitti_poses
from dynslam_tpu_torch.io.images import read_png
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence

torch.set_num_threads(2)

W, H, N = 160, 120, 4


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cliseq"))
    write_kitti_sequence(root, num_frames=N, width=W, height=H,
                         with_dynamic=True)
    return root


def _csv_names(out):
    return sorted(os.listdir(os.path.join(out, "csv")))


def test_staged_cli(seq, tmp_path, capsys):
    out = str(tmp_path / "out")
    ck = str(tmp_path / "ck.npz")
    rc = main.main(["--dataset_root", seq, "--cpu", "--tiny",
                    "--min_detection_size", "8", "--enable_evaluation",
                    "--evaluation_delay", "1", "--dump_previews_every", "2",
                    "--frame_limit", "3", "--checkpoint_out", ck,
                    "--out", out])
    assert rc == 0
    text = capsys.readouterr().out
    assert "[Finished frame 2 in" in text and "[checkpoint written" in text
    assert "LIDAR error overlay" in text  # skipped, with one line
    traj = read_kitti_poses(os.path.join(out, "trajectory.txt"))
    assert traj.shape == (3, 4, 4) and np.isfinite(traj).all()
    names = _csv_names(out)
    assert len(names) == 5 and all("-dynamic-mode-" in n for n in names)
    for kind in ("color", "depth"):
        img = read_png(os.path.join(out, f"frame000002_{kind}.png"))
        assert img.shape == (H, W, 3) and img.any()
    # resume the checkpoint for the rest of the sequence
    out2 = str(tmp_path / "out2")
    assert main.main(["--dataset_root", seq, "--cpu", "--tiny",
                      "--min_detection_size", "8", "--resume_from", ck,
                      "--out", out2]) == 0
    assert "[resumed from" in capsys.readouterr().out
    traj2 = read_kitti_poses(os.path.join(out2, "trajectory.txt"))
    assert traj2.shape == (N, 4, 4)
    np.testing.assert_allclose(traj2[:3], traj, atol=1e-6)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_fused_cli(seq, tmp_path, capsys, dynamic):
    out = str(tmp_path / "out")
    ck = str(tmp_path / "fused.npz")
    # max_depth 8 m: the --tiny window covers the frustum at that depth
    args = ["--dataset_root", seq, "--cpu", "--tiny", "--fused",
            "--max_depth", "8",
            "--min_detection_size", "8", "--enable_evaluation",
            "--dump_previews_every", "2", "--checkpoint_out", ck,
            "--out", out]
    if not dynamic:
        args.append("--no-dynamic_mode")
    assert main.main(args) == 0
    text = capsys.readouterr().out
    assert "[map:" in text and os.path.exists(ck)
    traj = read_kitti_poses(os.path.join(out, "trajectory.txt"))
    assert traj.shape == (N, 4, 4)  # the fused path writes the prior
    assert np.array_equal(traj[0], np.eye(4))
    assert os.path.exists(os.path.join(out, "frame000002_color.png"))
    assert len(_csv_names(out)) == 4 + dynamic  # the tracker file: dynamic


@pytest.mark.parametrize("flag", sorted(main.DEFERRED))
def test_deferred_flags_fail_loudly(seq, tmp_path, flag):
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 10"):
        main.main(["--dataset_root", seq, "--cpu", f"--{flag}",
                   "--out", str(tmp_path)])


def test_fused_rejects_delayed_evaluation(seq, tmp_path):
    with pytest.raises(SystemExit, match="evaluation_delay"):
        main.main(["--dataset_root", seq, "--cpu", "--fused",
                   "--enable_evaluation", "--evaluation_delay", "2",
                   "--out", str(tmp_path)])


def test_cuda_is_the_default_device(seq, tmp_path, monkeypatch):
    """Without --cpu the pipelines ask for the GPU and fail without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        main.main(["--dataset_root", seq, "--tiny", "--out", str(tmp_path)])
