"""Both packages' fused CLIs (``main --fused``, ``dynslam_tpu/main.py:
104-240``) over one folder the port's ``write_kitti_sequence`` wrote
(160x120, 5 frames, one car), static and dynamic, with
``--enable_evaluation --checkpoint_out``, on the CPU:

- the JAX CLI renders with its Pallas raycast in interpret mode
  (``jax_kernel_renders``; its pipelines built with ``use_pallas=True``),
  and the port's pipeline is fed the JAX pipeline's RANSAC draws, through
  ``build_fused`` wrapped in both packages as ``test_torch_cli.py::
  _capture_builds`` wraps it;
- trajectories within ``POSE_TOL``, the renders by ``check_renders``,
  the CSVs by the slice tests' rule (``test_torch_eval_slice.
  compare_csv_dirs``: max(5, 3%) a bucket), every port CSV row equal to
  the JAX evaluation of the port's render (``check_witness``). The car's
  pixels alone are not held to ``check_renders``' 0.99: at ``--tiny``'s
  object volumes the two renders of the car agree on 0.964-0.999 of them
  by frame (the car's motion parts by float order), within the CSV rule;
- each package's checkpoint loads in the other, leaf for leaf;
- the trajectory the CLI writes from the device poses it fetches once
  equals, byte for byte, the one a fetch a frame gave;
- a split run resumed from its checkpoint goes on from the checkpoint's
  frame, static to the continuous run's trajectory exactly (the JAX CLI
  reads a static checkpoint's sequence again from frame 0)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import dynslam_tpu.pipeline.fused as jfused
import dynslam_tpu.pipeline.fused_dynamic as jfd
from dynslam_tpu import main as jmain
from dynslam_tpu.pipeline import builder as jbuilder
from dynslam_tpu.pipeline import checkpoint as jck
from dynslam_tpu_torch import convert
from dynslam_tpu_torch import main as tmain
from dynslam_tpu_torch.io.calib import read_kitti_poses, write_kitti_poses
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence
from dynslam_tpu_torch.pipeline import builder as tbuilder
from dynslam_tpu_torch.pipeline import checkpoint as tck

from test_torch_eval_slice import (
    SubmitLog, check_renders, check_witness, compare_csv_dirs, render_flips,
)
from torch_frontend_inputs import (
    RENDER_CAND_K, jax_dynamic_sampler, jax_kernel_renders, jax_sample_ids,
)
from torch_threads import threads

torch_threads = threads(2)

W, H, N = 160, 120, 5
#: the CLIs' flags: the small pools of ``--tiny``, whose window covers the
#: frustum to 8 m (8 m also keeps every render under 16.384 m, past which
#: the JAX package's packed lookup reads a rendered depth back wrong), and
#: decay from frame 2
FLAGS = ["--cpu", "--tiny", "--fused", "--max_depth", "8",
         "--min_detection_size", "8", "--min_decay_age", "2",
         "--enable_evaluation"]
#: the two packages' trajectories, every entry (metres for the
#: translations): the fused slices part by ~3e-7 m after one step and
#: 1.7e-6 m after five (the Gauss-Newton solvers' float order); measured
#: here: 9.5e-7, static and dynamic
POSE_TOL = 2e-6
#: a resumed dynamic run against the continuous one, after the
#: checkpoint's frame: object tracking restarts at a resume, and the
#: checkpoint's map has had ``finalize``'s fusion-only replays (measured:
#: 3.6e-7); a resumed static run equals the continuous one (the checkpoint
#: holds the RANSAC generator's state)
RESUME_TOL = 1e-4
SPLIT = 3


def _patch_config(cfg):
    """Fields the CLIs have no flag for, set alike in both packages'
    ``build_fused``: 8 flow vectors make an object motion estimate, so the
    small car goes Dynamic; the object volumes' mu of 0.3 m keeps the two
    packages' renders of the car within the slice tests' bounds
    (``test_torch_eval_dynamic.py``)."""
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, min_flow_vectors=8),
        instance_map=dataclasses.replace(cfg.instance_map, mu_m=0.3))


class _PallasFused(jfused.FusedPipeline):
    def __init__(self, *args, **kw):
        super().__init__(*args, use_pallas=True, **kw)


class _PallasDyn(jfd.FusedDynamicPipeline):
    def __init__(self, *args, **kw):
        super().__init__(*args, use_pallas=True, **kw)


def _static_sampler(base_key, iters: int):
    def sampler(frame_idx, valid):
        key = jax.random.fold_in(base_key, frame_idx)
        return torch.tensor(jax_sample_ids(key, valid.numpy(), iters))
    return sampler


class _Run:
    """What one package's CLI run built and wrote."""

    def __init__(self, out):
        self.out, self.ck = out, out + ".npz"
        self.cfg = self.pipe = self.log = None
        #: each frame's pose fetched after its step (the CLI's old way)
        self.fetched = []

    def csv(self):
        return os.path.join(self.out, "csv")

    def trajectory(self):
        return read_kitti_poses(os.path.join(self.out, "trajectory.txt"))


def _wrap_build(mp, module, run, after=None):
    """Make ``module.build_fused`` patch the config, keep the pipeline in
    ``run``, log its evaluation's submits and call ``after(pipe)``."""
    build = module.build_fused

    def build_fused(root, cfg, **kw):
        run.cfg = _patch_config(cfg)
        pipe, inp, segp = build(root, run.cfg, **kw)
        run.pipe, run.log = pipe, SubmitLog(pipe.evaluation)
        if after is not None:
            after(pipe)
        return pipe, inp, segp
    mp.setattr(module, "build_fused", build_fused)


def _record_poses(run):
    """Fetch each frame's pose after its step, as the CLI did."""
    def after(pipe):
        process = pipe.process_frame

        def process_frame(*args, **kw):
            process(*args, **kw)
            if pipe.last_outputs is not None:
                run.fetched.append(pipe.last_outputs.pose_w2c.cpu().numpy())
        pipe.process_frame = process_frame
    return after


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fusedcli") / "seq")
    write_kitti_sequence(root, num_frames=N, width=W, height=H,
                         with_dynamic=True)
    return root


@pytest.fixture(scope="module", params=["static", "dynamic"])
def runs(request, seq, tmp_path_factory):
    """(JAX run, port run, mode) of the CLIs over ``seq``."""
    mode = request.param
    base = tmp_path_factory.mktemp(f"out-{mode}")
    jrun, trun = _Run(str(base / "jax")), _Run(str(base / "port"))
    flags = FLAGS + ["--dataset_root", seq] + (
        ["--no-dynamic_mode"] if mode == "static" else [])
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        mp.setattr(jfused, "FusedPipeline", _PallasFused)
        mp.setattr(jfd, "FusedDynamicPipeline", _PallasDyn)
        _wrap_build(mp, jbuilder, jrun)
        assert jmain.main(flags + ["--out", jrun.out, "--checkpoint_out",
                                   jrun.ck]) == 0
        record = _record_poses(trun)

        def after(pipe):
            key = jrun.pipe.base_key
            pipe.sampler = _static_sampler(key, pipe.vo_params.ransac_iters) \
                if mode == "static" else jax_dynamic_sampler(
                    key, pipe.K, pipe.vo_params.ransac_iters,
                    pipe.obj_params.ransac_iters)
            record(pipe)
        _wrap_build(mp, tbuilder, trun, after)
        assert tmain.main(flags + ["--out", trun.out, "--checkpoint_out",
                                   trun.ck]) == 0
    assert fill and max(fill) < RENDER_CAND_K
    return jrun, trun, mode


def test_trajectory_matches_jax(runs):
    jrun, trun, mode = runs
    a, b = jrun.trajectory(), trun.trajectory()
    assert a.shape == b.shape == (N, 4, 4)
    print(f"{mode}: max |trajectory(port) - trajectory(JAX)| "
          f"{np.abs(a - b).max():.3g}")
    assert np.abs(a - b).max() <= POSE_TOL, np.abs(a - b).max()
    if mode == "dynamic":
        (t,) = trun.pipe.tracker.active_tracks.values()
        assert t.state.value == "Dynamic" and t.has_reconstruction()


def test_csvs_match_jax(runs):
    jrun, trun, mode = runs
    check_renders(jrun.log, trun.log)
    assert len(os.listdir(trun.csv())) == (5 if mode == "dynamic" else 4)
    compare_csv_dirs(jrun.csv(), trun.csv(),
                     render_flips(jrun.log, trun.log, trun.pipe.evaluation))
    check_witness(jrun.pipe.evaluation, jrun.log, trun.log, trun.csv())


def _leaves(path) -> list:
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(int(data["n_leaves"]))]


def test_checkpoints_load_across_packages(runs, seq):
    """The JAX CLI's checkpoint restores into a fresh port pipeline, and the
    port CLI's into a fresh JAX pipeline, each leaf equal to the file's
    (dtype included); the port's names the next frame of the sequence."""
    jrun, trun, mode = runs
    port = tbuilder.build_fused(seq, trun.cfg, device="cpu")[0]
    tck.load_fused_checkpoint(jrun.ck, port)
    to_np = convert.fused_dyn_carry_to_numpy if mode == "dynamic" \
        else convert.fused_carry_to_numpy
    keys = convert.FUSED_DYN_CARRY_KEYS if mode == "dynamic" \
        else convert.FUSED_CARRY_KEYS
    got = to_np(port.carry)
    for k, leaf in zip(keys, _leaves(jrun.ck)):
        assert np.array_equal(np.asarray(got[k]), leaf), k

    jpipe = jbuilder.build_fused(seq, jrun.cfg)[0]
    assert jck.load_fused_checkpoint(trun.ck, jpipe) == N
    jleaves = jax.tree_util.tree_leaves(jpipe.carry)
    assert len(jleaves) == len(keys)
    for i, (a, b) in enumerate(zip(jleaves, _leaves(trun.ck))):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(
            np.asarray(a), b), i


def test_trajectory_unchanged_by_device_poses(runs, tmp_path):
    """The trajectory the CLI writes from the poses it keeps on the device
    and fetches once equals, byte for byte, the one it wrote when it
    fetched each frame's pose after the step."""
    _, trun, _ = runs
    # the dynamic pipeline's finalize steps it twice more (fusion-only
    # replays), after the CLI's loop
    fetched = trun.fetched[:N - 1]
    assert len(fetched) == N - 1
    old = str(tmp_path / "old.txt")
    write_kitti_poses(old, np.stack(
        [np.eye(4)] + [np.linalg.inv(p) for p in fetched]))
    assert open(old).read() == open(
        os.path.join(trun.out, "trajectory.txt")).read()


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_resume_goes_on_from_checkpoint(seq, tmp_path, capsys, mode):
    """The port's CLI run split at frame ``SPLIT`` and resumed writes the
    continuous run's trajectory: equal static; dynamic, the first
    ``SPLIT`` rows equal and the rest within ``RESUME_TOL``. The JAX CLI
    resumes a static checkpoint at frame 0 instead."""
    flags = FLAGS + ["--dataset_root", seq] + (
        ["--no-dynamic_mode"] if mode == "static" else [])
    out = {k: str(tmp_path / k) for k in ("cont", "first", "resumed")}
    ck = str(tmp_path / "split.npz")
    assert tmain.main(flags + ["--out", out["cont"]]) == 0
    assert tmain.main(flags + ["--out", out["first"], "--frame_limit",
                               str(SPLIT), "--checkpoint_out", ck]) == 0
    assert tmain.main(flags + ["--out", out["resumed"], "--resume_from",
                               ck]) == 0
    assert f"[resumed from {ck} at frame {SPLIT}]" in capsys.readouterr().out
    cont, first, resumed = (read_kitti_poses(os.path.join(o,
                                                          "trajectory.txt"))
                            for o in out.values())
    assert first.shape == (SPLIT, 4, 4) and resumed.shape == cont.shape
    assert np.array_equal(first, cont[:SPLIT])
    assert np.array_equal(resumed[:SPLIT], cont[:SPLIT])
    print(f"{mode}: max |resumed - continuous| "
          f"{np.abs(resumed - cont).max():.3g}")
    assert np.abs(resumed - cont).max() <= RESUME_TOL
    assert mode == "dynamic" or np.array_equal(resumed, cont)
    if mode == "static":
        _static_checkpoint_frames(flags, ck, tmp_path, capsys)


def _static_checkpoint_frames(flags, port_ck, tmp_path, capsys):
    """A static checkpoint the JAX CLI saved names frame 0: the JAX CLI
    resumes it there and reads the whole sequence again; the port resumes
    it at the frame it was saved at, and writes the resumed frames alone
    (it holds no earlier poses). The JAX CLI resumes the port's at its
    frame."""
    ck = str(tmp_path / "jax_split.npz")
    assert jmain.main(flags + ["--out", str(tmp_path / "jfirst"),
                               "--frame_limit", str(SPLIT),
                               "--checkpoint_out", ck]) == 0
    capsys.readouterr()
    for m, path, frame, rows in ((jmain, ck, 0, N + 1),
                                 (tmain, ck, SPLIT, N - SPLIT),
                                 (jmain, port_ck, SPLIT, N - SPLIT + 1)):
        out = str(tmp_path / f"resumed-{m.__name__}-{frame}")
        assert m.main(flags + ["--out", out, "--resume_from", path]) == 0
        text = capsys.readouterr().out
        assert f"[resumed from {path} at frame {frame}]" in text
        traj = read_kitti_poses(os.path.join(out, "trajectory.txt"))
        assert traj.shape == (rows, 4, 4), (m.__name__, traj.shape)
