"""The port's scripts (``dynslam_tpu_torch/scripts/``) beside the JAX
package's (``scripts/``), on the CPU at small sizes: ``scale_sequence``'s
files byte for byte (the JAX script run in a subprocess, as
``tests/test_scale_sequence.py`` runs it), ``experiments``' command lines
(``subprocess.call`` captured in both), ``measure_fallback``'s fallback
fusion against JAX's ``fuse_slot_fullframe`` on the same inputs,
``profile_dynamic``'s stages; and ``scripts/plot_results.py``, unchanged,
over the CSVs of the port CLI's evaluation run (it needs no port)."""

import filecmp
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.pipeline.fused_dynamic import (
    FusedDynamicPipeline as JaxDynPipeline, fuse_slot_fullframe as jfuse,
)
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence
from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic
from dynslam_tpu_torch.pipeline.fused_dynamic import fuse_slot_fullframe
from dynslam_tpu_torch.scripts import (
    experiments, measure_fallback, profile_dynamic, scale_sequence,
)

from test_torch_fused_dynamic import assert_words_after
from test_torch_integrate import assert_colors_close
from torch_frontend_inputs import dynamic_slice_config
from torch_threads import threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


torch_threads = threads(2)


def _jax_script(name, *args):
    """The JAX package's ``scripts/<name>.py`` in a subprocess on the
    CPU, started now (``communicate()`` waits)."""
    return subprocess.Popen(
        [sys.executable, f"scripts/{name}.py", *map(str, args)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_scale_sequence_bytes_equal_jax(tmp_path):
    """Every file the two scripts write at scale 0.5 (images, gray pairs,
    ELAS XML depth from the census matcher, rescaled MNC dumps) is the
    same byte for byte."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    write_kitti_sequence(port, num_frames=3, width=192, height=96,
                         with_dynamic=True)
    before = set(_files(port))
    import shutil

    shutil.copytree(port, ref)
    jax_run = _jax_script("scale_sequence", "--dataset_root", ref,
                          "--scale", "0.5", "--cpu")
    scale_sequence.main(["--dataset_root", port, "--scale", "0.5", "--cpu"])
    _, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-2000:]
    made = sorted(set(_files(port)) - before)
    assert made == sorted(set(_files(ref)) - before)
    for d in ("image_0_0.50", "image_1_0.50", "image_2_0.50",
              "image_3_0.50", "precomputed-depth-elas-0.50/Frames",
              "seg_image_2-0.50/mnc"):
        assert any(f.startswith(d) for f in made), d
    differ = [f for f in made if not filecmp.cmp(
        os.path.join(port, f), os.path.join(ref, f), shallow=False)]
    assert not differ, differ


def _load_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["decay", "--dataset_root", "/data/09", "--frame_limit", "50"],
    ["odo", "--dataset_base", "/data/odo", "--seqs", "00", "06"],
    ["lowfreq", "--dataset_root", "/data/09"],
    ["tracking", "--dataset_base", "/data/trk", "--seqs", "0", "3"],
], ids=["decay", "odo", "lowfreq", "tracking"])
def test_experiments_command_lines(argv, monkeypatch):
    """The same runs with the same flags, ``-m dynslam_tpu_torch.main``
    for ``-m dynslam_tpu.main``. (The JAX script passes the tracking
    sequence id as an int, on which it fails; the port passes its
    string.)"""
    jexp = _load_script("experiments")
    # the JAX script's tracking recipe hands run_cli an int, on which its
    # " ".join fails: give it the strings the port passes
    run_cli = jexp.run_cli
    monkeypatch.setattr(jexp, "run_cli", lambda extra, tag, out: run_cli(
        [str(a) for a in extra], tag, out))
    calls = []
    # both scripts call the one ``subprocess`` module
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, cwd: calls.append((cmd, cwd)) or 0)
    monkeypatch.setattr(sys, "argv", ["experiments.py"] + argv
                        + ["--out", "/exp"])
    jexp.main()
    ran, calls[:] = list(calls), []
    experiments.main(argv + ["--out", "/exp"])
    want = [([str(a).replace("dynslam_tpu.main", "dynslam_tpu_torch.main")
              for a in cmd], cwd) for cmd, cwd in ran]
    assert len(want) > 1 and calls == want


def test_measure_fallback_equals_jax():
    """Three fallback fusions (the first resets its slot) of the script's
    close car, the same numpy inputs into both packages: the pooled
    volumes' blocks exact, their words as ``assert_words_after`` holds
    them after one fused frame, their colours by
    ``assert_colors_close``."""
    cfg = dynamic_slice_config()
    jp = JaxDynPipeline(cfg, cfg.calibration, use_pallas=False)
    tp = build_fused_dynamic(cfg, cfg.calibration, device="cpu")
    from dynslam_tpu.ops import tsdf as jt
    from dynslam_tpu_torch.ops import tsdf as tt

    one = jt.create_state(jp.icfg)
    jinst = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (jp.S,) + x.shape).copy(), one)
    jfidx = jnp.zeros(jp.S, jnp.int32)
    tinst = tt.create_pool(tp.icfg, tp.S, "cpu")
    tfidx = np.zeros(tp.S, np.int32)
    rng = np.random.default_rng(0)
    h, w = cfg.frame_height, cfg.frame_width
    for rep in range(3):
        depth, mask, rgb = measure_fallback.close_car(h, w, rng)
        assert mask.sum() > 1000
        slot = rep % 2
        jinst, jfidx = jfuse(jp.icfg, False, True, jinst, jfidx,
                             jnp.int32(slot), jnp.asarray(depth),
                             jnp.asarray(rgb), jnp.asarray(mask),
                             jnp.eye(4, dtype=jnp.float32),
                             jnp.bool_(rep == 0), jp.intr_vec,
                             jnp.float32(1.0), jnp.int32(200))
        fuse_slot_fullframe(
            tp.icfg, True, tinst, tfidx, slot, torch.from_numpy(depth),
            torch.from_numpy(rgb), mask, np.eye(4, dtype=np.float32),
            rep == 0, tp.intr_host, 1.0, 200)
    assert np.array_equal(tfidx, np.asarray(jfidx))
    for s in range(2):
        valid = np.asarray(jinst.valid[s])
        assert np.array_equal(tinst.valid[s].numpy(), valid)
        assert np.array_equal(tinst.block_coords[s].numpy(),
                              np.asarray(jinst.block_coords[s]))
        used = np.nonzero(valid)[0][:-1]
        assert used.size > 50
        assert_words_after(1, np.asarray(jinst.tsdf_w[s])[used],
                           tinst.tsdf_w[s].numpy()[used])
        assert_colors_close(np.asarray(jinst.color[s])[used],
                            tinst.color[s].numpy()[used])


def test_measure_fallback_reps_time_each_part():
    cfg = dynamic_slice_config()
    res = measure_fallback.measure(cfg, reps=2, device="cpu",
                                   log=lambda m: None)
    assert [set(t) for t in res["times"]] == [
        {"host_ms", "upload_ms", "run_ms"}] * 2
    assert list(res["fidx"][:2]) == [1, 1]
    assert int(res["inst"].valid[0].sum()) > 50


def test_profile_dynamic_sees_every_stage(tmp_path, capsys):
    """Four frames of the dynamic slice's scene, the last two profiled:
    every stage range of ``STAGES`` is timed and printed."""
    from torch_frontend_inputs import make_dynamic_frames

    from dynslam_tpu_torch.io.segmentation import detections_from_instance_ids

    cfg = dynamic_slice_config()
    frames = make_dynamic_frames(cfg, 4)
    res = profile_dynamic.profile(
        cfg, np.stack([f[0] for f in frames]).astype(np.uint8),
        np.stack([f[1] for f in frames]).astype(np.uint8),
        [detections_from_instance_ids(f[3], min_size_px=8, score=0.98)
         for f in frames], 1, tmp_path, "cpu")
    printed = capsys.readouterr().out
    for stage in profile_dynamic.STAGES:
        assert stage in res and res[stage][0] > 0
        assert f"[profile] {stage}" in printed


def test_plot_results_over_port_csvs(tmp_path):
    """``scripts/plot_results.py`` reads the port CLI's evaluation CSVs as
    they are and writes an accuracy plot of each depth-result CSV and a
    plot of the memory CSV."""
    from dynslam_tpu_torch import main

    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    write_kitti_sequence(seq, num_frames=3, width=128, height=96)
    assert main.main(["--dataset_root", seq, "--cpu", "--tiny", "--fused",
                      "--no-dynamic_mode", "--max_depth", "8",
                      "--enable_evaluation", "--out", out]) == 0
    plots = str(tmp_path / "plots")
    r = subprocess.run([sys.executable, "scripts/plot_results.py",
                        "--csv_dir", os.path.join(out, "csv"), "--out",
                        plots], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    csvs = [f for f in os.listdir(os.path.join(out, "csv"))
            if f.endswith(("depth-result.csv", "-memory.csv"))]
    assert any(f.endswith("-memory.csv") for f in csvs) and any(
        f.endswith("unified-depth-result.csv") for f in csvs), csvs
    assert sorted(os.listdir(plots)) == sorted(
        f.replace(".csv", ".png") for f in csvs)
    assert "skipping" not in r.stderr, r.stderr
