"""The port's headless demo (``dynslam_tpu_torch/scripts/
demo_synthetic.py``) beside the JAX package's ``scripts/
demo_synthetic.py`` (a subprocess on the CPU) on the same 3-frame
128x96 synthetic sequence: the previews written, and the two
trajectories within the staged slice's settled pose gap
(``test_torch_dynslam.MAX_POSE_GAP_M``, 5 mm; the port draws its own
RANSAC hypotheses here) and near the ground truth."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynslam_tpu_torch.io.calib import read_kitti_poses
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence
from dynslam_tpu_torch.scripts import demo_synthetic

from test_torch_dynslam import MAX_POSE_GAP_M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--frames", "3", "--width", "128", "--height", "96", "--cpu"]


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_demo_beside_jax(tmp_path, dynamic):
    seq = str(tmp_path / "seq")
    write_kitti_sequence(seq, num_frames=3, width=128, height=96,
                         with_dynamic=dynamic)
    extra = ["--seq-root", seq] + (["--dynamic"] if dynamic else [])
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_run = subprocess.Popen(
        [sys.executable, "scripts/demo_synthetic.py", *ARGS, *extra,
         "--out", jout], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    res = demo_synthetic.main(ARGS + extra + ["--out", tout])
    _, err = jax_run.communicate(timeout=900)
    assert jax_run.returncode == 0, err[-2000:]
    assert res["frames"] == 3
    for out in (jout, tout):
        names = sorted(os.listdir(out))
        assert "trajectory.txt" in names
        assert {f"frame{n:04d}_{p}.png" for n in (1, 2)
                for p in ("color", "depth", "normal")} <= set(names)
    a = read_kitti_poses(os.path.join(jout, "trajectory.txt"))
    b = read_kitti_poses(os.path.join(tout, "trajectory.txt"))
    assert a.shape == b.shape == (3, 4, 4)
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= MAX_POSE_GAP_M
    gt = read_kitti_poses(os.path.join(seq, "ground-truth-poses.txt"))
    assert np.abs(b[:, :3, 3] - gt[:3, :3, 3]).max() <= 0.05
