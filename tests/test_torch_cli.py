"""``dynslam_tpu_torch.main`` end to end on the CPU (``--cpu --tiny``)
over a folder the port's ``write_kitti_sequence`` wrote: the staged path
with evaluation, previews (the LIDAR error overlay included) and a
checkpoint, its resume, and the fused steps (``--fused``, static and
dynamic); each output flag on the paths that take it; ``--frame_limit``
after ``--resume_from`` in both packages' CLIs; the fused path's
end-of-run warnings."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dynslam_tpu_torch import main
from dynslam_tpu_torch.io.calib import read_kitti_poses
from dynslam_tpu_torch.io.images import read_png
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence
from torch_threads import threads

torch_threads = threads(2)

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
    overlay = read_png(os.path.join(out, "frame000002_lidar_error.png"))
    assert overlay.shape == (H, W, 3) and overlay.any()
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


def _capture_builds(monkeypatch) -> list:
    """Keep what ``build_dynslam`` and ``build_fused`` return to the CLI."""
    from dynslam_tpu_torch.pipeline import builder

    built = []
    for name in ("build_dynslam", "build_fused"):
        fn = getattr(builder, name)
        monkeypatch.setattr(builder, name, lambda *a, _fn=fn, **k: (
            built.append(_fn(*a, **k)) or built[-1]))
    return built


def _dynamic_tracker(monkeypatch):
    """tests/test_dynamic_pipeline.py's tracker (8 flow vectors make a
    motion estimate), so that the car of these small frames goes Dynamic
    and gets a volume."""
    make = main.make_config

    def make_config(args):
        cfg = make(args)
        return dataclasses.replace(cfg, tracker=dataclasses.replace(
            cfg.tracker, min_flow_vectors=8))
    monkeypatch.setattr(main, "make_config", make_config)


@pytest.mark.parametrize("flag,path", [
    ("save_mesh", "staged"), ("save_mesh", "fused"),
    ("save_object_meshes", "staged"), ("save_object_meshes", "fused"),
    ("prefetch", "staged"), ("prefetch", "fused"),
    ("direct_refinement", "staged"), ("direct_refinement", "fused")])
def test_cli_flag_runs(seq, tmp_path, capsys, monkeypatch, flag, path):
    """Each output flag on each path: what it writes or prints. The fused
    path refuses ``--direct_refinement`` as the JAX CLI does."""
    from dynslam_tpu_torch.viz.meshing import extract_mesh

    _dynamic_tracker(monkeypatch)
    out = str(tmp_path / "out")
    args = ["--dataset_root", seq, "--cpu", "--tiny", "--min_detection_size",
            "8", "--out", out, f"--{flag}"]
    if path == "fused":
        args += ["--fused", "--max_depth", "8"]
        if flag == "direct_refinement":
            with pytest.raises(SystemExit, match="--direct_refinement"):
                main.main(args)
            return
    pipes = _capture_builds(monkeypatch)
    assert main.main(args) == 0
    text = capsys.readouterr().out
    traj = read_kitti_poses(os.path.join(out, "trajectory.txt"))
    assert traj.shape == (N, 4, 4) and np.isfinite(traj).all()
    pipe, input_ = pipes[0][0], pipes[0][1]
    if flag == "save_mesh":
        lines = open(os.path.join(out, "static_map.obj")).read().splitlines()
        n_v = sum(ln.startswith("v ") for ln in lines)
        faces = np.array([[int(x) for x in ln.split()[1:]]
                          for ln in lines if ln.startswith("f ")])
        assert len(faces) > 10_000 and faces.min() >= 1 \
            and faces.max() <= n_v
        state = pipe.static_scene.state if path == "staged" \
            else pipe.carry.state
        assert len(faces) == extract_mesh(state, 0.05)[1].shape[0]
        assert f"[saved static map mesh: {len(faces)} triangles]" in text
    elif flag == "save_object_meshes":
        objs = sorted(n for n in os.listdir(out) if n.startswith("object_"))
        assert objs and all(n.endswith("_car.obj") for n in objs)
        tris = [sum(ln.startswith("f ") for ln in open(os.path.join(out, n)))
                for n in objs]
        assert max(tris) > 100 and "[saved object #" in text
    elif flag == "prefetch":
        from dynslam_tpu_torch.io.prefetch import PrefetchingInput

        assert isinstance(input_, PrefetchingInput)
        assert input_._pending is None  # closed at the end
    else:
        refined = pipe.instance_reconstructor.direct_refinements
        assert refined >= 1
        assert f"[direct refinement: {refined} object motions refined]" \
            in text


def test_resume_frame_limit_counts_absolute_frames(seq, tmp_path, capsys):
    """``--frame_limit`` after ``--resume_from`` counts frames from the
    sequence's start in both packages' staged CLIs
    (``dynslam_tpu/main.py:405``): a run resumed at frame 2 with limit 3
    processes frame 2 alone."""
    from dynslam_tpu import main as jmain

    ck = str(tmp_path / "ck.npz")
    base = ["--dataset_root", seq, "--cpu", "--tiny", "--no-dynamic_mode"]
    assert main.main(base + ["--frame_limit", "2", "--checkpoint_out", ck,
                             "--out", str(tmp_path / "first")]) == 0
    trajs = []
    for tag, m in (("jax", jmain), ("port", main)):
        out = str(tmp_path / tag)
        assert m.main(base + ["--resume_from", ck, "--frame_limit", "3",
                              "--out", out]) == 0
        trajs.append(read_kitti_poses(os.path.join(out, "trajectory.txt")))
    text = capsys.readouterr().out
    assert "[Finished frame 2 in" in text and "[Finished frame 3 in" \
        not in text
    jt, tt = trajs
    assert jt.shape == tt.shape == (3, 4, 4)
    np.testing.assert_allclose(tt, jt, atol=5e-3)


def test_fused_warnings(tmp_path, capsys, monkeypatch):
    """The fused path's end-of-run warnings (``dynslam_tpu/main.py:
    241-250``) with the pipeline's counters: three cars against one mask
    slot (detections dropped) and a fusion crop smaller than a car (the
    oversize masks, each fused by the full-frame fallback)."""
    root = str(tmp_path / "seq")
    write_kitti_sequence(root, num_frames=N, width=W, height=H,
                         with_dynamic=True, n_dynamic=3)
    make = main.make_config

    def make_config(args):
        cfg = make(args)
        return dataclasses.replace(cfg, instance_map=dataclasses.replace(
            cfg.instance_map, max_detections=1, max_objects=1,
            fusion_crop=(16, 16)), tracker=dataclasses.replace(
                cfg.tracker, min_flow_vectors=8))
    monkeypatch.setattr(main, "make_config", make_config)
    pipes = _capture_builds(monkeypatch)
    assert main.main(["--dataset_root", root, "--cpu", "--tiny", "--fused",
                      "--max_depth", "8", "--min_detection_size", "8",
                      "--out", str(tmp_path / "out")]) == 0
    text = capsys.readouterr().out
    pipe = pipes[0][0]
    nd, ov = pipe.get_dropped_detection_count(), pipe.oversize_masks
    assert nd > 0 and ov > 0
    assert f"[WARNING: {nd} detections exceeded the 1 mask slots over the " \
        f"run (largest kept); raise instance_map.max_detections]" in text
    assert f"[{ov} oversized masks exceeded the fusion crop; " \
        f"{pipe.truncated_pixels} px truncated (0 = every one took the " \
        f"full-frame fallback)]" in text


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


class _Built(Exception):
    """Raised by a recording ``build_dynslam`` to stop the CLI there."""


def _record_build(monkeypatch, module) -> list:
    """Make ``module.build_dynslam`` record its arguments and stop."""
    calls = []

    def build_dynslam(*args, **kw):
        calls.append((args, kw))
        raise _Built

    monkeypatch.setattr(module, "build_dynslam", build_dynslam)
    return calls


#: the staged CLI's depth-input and odometry option sets
#: (tests/test_torch_staged_options.py runs each in both packages);
#: ICP as the primary odometry has no flag in either CLI
#: (``external_odometry`` is a config field), so its case checks that both
#: CLIs keep the default; and the KITTI tracking layout
#: (tests/test_torch_tracking_layout.py runs it)
OPTION_SETS = {
    "depth-weighting": ["--use_depth_weighting", "--fusion_every", "2"],
    "live-stereo": ["--use_live_stereo", "--fill_disparity_gaps", "8",
                    "--use_bilateral_filter"],
    "dispnet": ["--use_dispnet"],
    "half-scale": ["--scale", "2"],
    "icp-primary": [],
    "kitti-tracking": ["--dataset_type", "kitti-tracking",
                       "--kitti_tracking_sequence_id", "0"],
}


@pytest.mark.parametrize("case", list(OPTION_SETS))
def test_option_set_config_equals_jax(seq, tmp_path, monkeypatch, case):
    """The config and the ``build_dynslam`` arguments the port's CLI
    builds for an option set equal those the JAX package's CLI builds
    inline (``dynslam_tpu/main.py``), its ``build_dynslam`` stopped at the
    call; nothing runs."""
    from dynslam_tpu import main as jmain
    from dynslam_tpu.pipeline import builder as jbuilder
    from dynslam_tpu_torch.pipeline import builder as tbuilder

    from test_torch_eval import to_port

    flags = OPTION_SETS[case]
    args = ["--dataset_root", seq, "--cpu", "--out", str(tmp_path)] + flags
    jcalls = _record_build(monkeypatch, jbuilder)
    tcalls = _record_build(monkeypatch, tbuilder)
    for m in (jmain, main):
        with pytest.raises(_Built):
            m.main(args)
    (jargs, jkw), (targs, tkw) = jcalls + tcalls
    assert targs[0] == jargs[0] == seq
    assert to_port(jargs[1]) == targs[1] \
        == main.make_config(main.build_arg_parser().parse_args(args))
    assert tkw.pop("device").type == "cpu"
    assert tkw == jkw
    cfg = targs[1]
    assert (cfg.map.use_depth_weighting, cfg.fusion_every) == (
        (True, 2) if case == "depth-weighting" else (False, 1))
    assert (tkw["use_live_stereo"], cfg.stereo.fill_gaps,
            cfg.use_bilateral_filter) == (
        (True, 8, True) if case == "live-stereo" else (False, 0, False))
    assert cfg.use_dispnet == (case == "dispnet")
    assert cfg.scale == (2.0 if case == "half-scale" else 1.0)
    assert tkw["kitti_tracking_sequence"] == (
        0 if case == "kitti-tracking" else None)
    assert cfg.external_odometry
    for parser in (jmain.build_arg_parser(), main.build_arg_parser()):
        assert not any("odometry" in a for action in parser._actions
                       for a in action.option_strings)
