"""The port's bench (``dynslam_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU:

- the orchestrator: ``_run_mode``'s four cases of
  ``tests/test_bench_orchestrator.py`` (success, a failing child, a
  timeout that kills the child, no JSON), the order of the printed lines
  (the static line first and last), the artifacts under the port's names
  and a non-zero exit when a mode fails;
- both modes with evaluation on, both packages' ``main_static`` /
  ``main_dynamic`` over one ``write_kitti_sequence`` folder (160x120, 6
  frames, one car) and the same noisy frames: JAX's ``bench.py`` loaded
  as ``test_bench_orchestrator.py`` loads it, its ``W``, ``H``,
  ``N_FRAMES``, ``ensure_seq``, ``load_frames`` and ``bench_config``
  patched, its renders by the Pallas raycast in interpret mode
  (``jax_kernel_renders``), the port fed JAX's RANSAC draws through a
  wrapped ``build_fused`` (``test_torch_fused_cli.py``), which also
  gives JAX's evaluation a CSV directory of the test's own. The result
  lines' keys and fields, the CSVs (``compare_csv_dirs``: max(5, 3%) a
  bucket; ``check_witness``), the static voxel-ops a frame, and at
  dispatch lag 1 and 2 with ``--verbose`` the ``[tracker]`` lines, text
  for text;
- ``process_frame``'s ``masks_dev`` (the bench worker's pre-uploaded
  bit-planes) changes no output word;
- ``ensure_seq``'s writer over pool-rendered frames equals
  ``write_kitti_sequence``'s folder byte for byte;
- ``scripts/bench_variance.py`` over a stub bench."""

import contextlib
import io
import json
import os
import re
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import dynslam_tpu.config as jconfig
import dynslam_tpu.pipeline.fused as jfused
import dynslam_tpu.pipeline.fused_dynamic as jfd
import dynslam_tpu_torch.config as tconfig
from dynslam_tpu.pipeline import builder as jbuilder
from dynslam_tpu_torch import bench as tbench
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.device import upload
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence
from dynslam_tpu_torch.pipeline import builder as tbuilder
from dynslam_tpu_torch.scripts import bench_setup as tbs
from dynslam_tpu_torch.scripts import bench_variance

from test_bench_orchestrator import _load_bench
from test_torch_eval_slice import (
    SubmitLog, check_renders, check_witness, compare_csv_dirs, render_flips,
)
from test_torch_fused_cli import _PallasDyn, _PallasFused, _static_sampler
from torch_frontend_inputs import RENDER_CAND_K, jax_dynamic_sampler, \
    jax_kernel_renders
from torch_threads import threads

torch_threads = threads(2)

W, H, N = 160, 120, 6
#: the frames' noise (the port's ``load_frames`` takes a seed)
NOISE_SEED = 5
#: the result fields only the port's lines have
DEVICE_KEYS = {"device", "power_limit_w"}


def _stub(tmp_path, body, name="stub_bench.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------


def test_run_mode_success(tmp_path, monkeypatch):
    stub = _stub(tmp_path, """
        import json, sys
        print("noise to stderr", file=sys.stderr)
        print(json.dumps({"metric": "m", "value": 12.3}))
    """)
    monkeypatch.setattr(tbench, "CHILD_CMD", [sys.executable, stub])
    assert tbench._run_mode(["--static"], timeout_s=30) == {
        "metric": "m", "value": 12.3}


def test_run_mode_child_failure(tmp_path, monkeypatch):
    stub = _stub(tmp_path, """
        import sys
        sys.exit(3)
    """)
    monkeypatch.setattr(tbench, "CHILD_CMD", [sys.executable, stub])
    res = tbench._run_mode(["--static"], timeout_s=30)
    assert res["value"] is None and "rc=3" in res["error"]


def test_run_mode_timeout_kills_child(tmp_path, monkeypatch):
    """The child is killed at the timeout: it never writes its file."""
    flag = tmp_path / "survived"
    stub = _stub(tmp_path, f"""
        import time
        time.sleep(3)
        open({str(flag)!r}, "w").close()
    """)
    monkeypatch.setattr(tbench, "CHILD_CMD", [sys.executable, stub])
    res = tbench._run_mode(["--static"], timeout_s=1)
    assert res["value"] is None and "timed out" in res["error"]
    time.sleep(3)
    assert not flag.exists()


def test_run_mode_non_json_output(tmp_path, monkeypatch):
    stub = _stub(tmp_path, """
        print("not json")
    """)
    monkeypatch.setattr(tbench, "CHILD_CMD", [sys.executable, stub])
    res = tbench._run_mode(["--static"], timeout_s=30)
    assert res["value"] is None and "no JSON" in res["error"]


#: a bench mode's stand-in: its line names its flags; ``--dynamic
#: --eval`` fails when the environment says so
MODE_STUB = """
    import json, os, sys
    flags = sys.argv[1:]
    if os.environ.get("FAIL_DYN_EVAL") and "--dynamic" in flags \\
            and "--eval" in flags:
        sys.exit(2)
    res = {"metric": " ".join(flags), "value": 1.0 + len(flags),
           "unit": "fps", "device": "stub", "power_limit_w": 1.0}
    if "--eval" in flags:
        res["eval_csv_rows"] = 5
    print(json.dumps(res))
"""


@pytest.mark.parametrize("fail", [False, True])
def test_orchestrator_lines_artifacts_and_exit(tmp_path, monkeypatch, capsys,
                                               fail):
    """Static, dynamic, dynamic eval-on, static eval-on, then the static
    line again; the artifacts under the port's names in ``--out``; exit 0,
    or 1 when a mode failed (the other modes still run)."""
    stub = _stub(tmp_path, MODE_STUB)
    monkeypatch.setattr(tbench, "CHILD_CMD", [sys.executable, stub])
    monkeypatch.setattr(tbench, "prepare", lambda n, cpu: None)
    if fail:
        monkeypatch.setenv("FAIL_DYN_EVAL", "1")
    out = tmp_path / "out"
    rc = tbench.main(["--cpu", "--verbose", "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r.get("metric") for r in lines] == [
        "--static --verbose --cpu", "--dynamic --verbose --cpu",
        None if fail else "--dynamic --eval --verbose --cpu",
        "--static --eval --verbose --cpu", "--static --verbose --cpu"]
    assert lines[0] == lines[-1]
    assert rc == (1 if fail else 0)
    assert sorted(os.listdir(out)) == ["BENCH_TORCH_DYNAMIC.json",
                                       "BENCH_TORCH_EVAL.json"]
    dyn = json.loads((out / "BENCH_TORCH_DYNAMIC.json").read_text())
    ev = json.loads((out / "BENCH_TORCH_EVAL.json").read_text())
    assert dyn["value"] == lines[1]["value"] and dyn["device"] == "stub"
    assert dyn["static_eval_on_fps"] == lines[3]["value"]
    assert dyn["eval_on_fps"] == (None if fail else lines[2]["value"])
    assert ev["static_eval_on"] == lines[3] and ev["device"] == "stub"
    assert ev["dynamic_eval_on"] == lines[2]
    assert not (tmp_path / "BENCH_DYNAMIC.json").exists()


# ---------------------------------------------------------------------------
# the sequences and bench_variance
# ---------------------------------------------------------------------------


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("dynamic", [False, True])
def test_ensure_seq_equals_write_kitti_sequence(tmp_path, dynamic):
    """Every file of ``ensure_seq``'s folder (``write_seq`` over the
    frames ``render_sets`` rendered) equals ``write_kitti_sequence``'s for
    bench.py's arguments (``bench.py:80-95``), here at 160x120x4 with the
    bench camera scaled to that size."""
    n, s = 4, W / tbs.W
    intr = tconfig.Intrinsics(707.0912 * s, 707.0912 * s, W / 2.0,
                              183.1104 * H / tbs.H)
    calib = tconfig.StereoCalibration(0.537150654273, intr.fx)
    rset = tbs.seq_set(dynamic, n)._replace(
        key=f"small-{dynamic}", intrinsics=intr, calib=calib, width=W,
        height=H)
    got = str(tmp_path / "pool")
    tbs.write_seq(got, rset, tbs.render_sets([rset], tmp_path / "cache")[0])
    want = str(tmp_path / "serial")
    write_kitti_sequence(
        want, num_frames=n, width=W, height=H, intrinsics=intr, calib=calib,
        with_dynamic=dynamic, n_dynamic=3, write_velodyne=True,
        write_elas_xml=False, write_dispnet=False, seed=11,
        scene_kwargs=(dict(n_rows=11, recurring_oncoming=2) if dynamic
                      else dict(n_rows=11)),
        trajectory_kwargs=dict(speed=0.8, yaw_rate=0.003))
    names = _files(want)
    assert _files(got) == names
    assert any(f.startswith("seg_image_2") for f in names) == dynamic
    for name in names:
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name


def test_bench_variance_over_stub(tmp_path, monkeypatch, capsys):
    """N runs of the stub, the failed one left out, the spread and the
    device fields of the runs."""
    count = tmp_path / "count"
    stub = _stub(tmp_path, f"""
        import json, os, sys
        p = {str(count)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        if n == 1:
            sys.exit(1)
        print("[bench] noise", file=sys.stderr)
        print(json.dumps({{"value": [2.0, None, 4.5][n], "flags": sys.argv[1:],
                          "device": "stub", "power_limit_w": 2.0}}))
    """)
    monkeypatch.setattr(bench_variance, "BENCH_CMD", [sys.executable, stub])
    assert bench_variance.main(["--runs", "3", "--mode", "static", "--eval",
                                "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out == {"mode": "static", "eval": True, "runs": [2.0, 4.5],
                   "min": 2.0, "max": 4.5, "mean": 3.25, "device": "stub",
                   "power_limit_w": 2.0}


# ---------------------------------------------------------------------------
# both packages' bench modes
# ---------------------------------------------------------------------------


def small_config(C, dynamic: bool):
    """bench.py's ``bench_config`` at 160x120 (the package's config module
    ``C``): the CLI's ``--tiny`` pools, a 64-pixel stereo range, renders
    under 8 m (past 16.384 m the JAX package reads a rendered depth back
    wrong), the bench's decay age (200: no decay in 6 frames; at 2 the
    small car's volume decays to 0 blocks by the end), and detections and
    object motions of the small car (8 px, 8 flow vectors; object mu 0.3
    m as ``test_torch_fused_cli.py``). The shipped 16 mask slots and 8 volumes;
    the 256x512 fusion crop covers the frame, so no mask takes the
    oversize fallback."""
    intr = C.Intrinsics(0.8 * W, 0.8 * W, W / 2.0, H / 2.0)
    return C.DynSlamConfig(
        frame_width=W, frame_height=H, intrinsics=intr,
        calibration=C.StereoCalibration(0.5, intr.fx),
        dynamic_mode=dynamic, max_depth_m=8.0,
        scene=C.SceneParams(voxel_size_m=0.05, mu_m=0.30),
        map=C.MapParams(pool_capacity=16384, local_dims=(80, 32, 80),
                        max_new_blocks_per_frame=4096),
        instance_map=C.InstanceMapParams(
            blocks_per_object=1024, local_dims=(48, 24, 64),
            max_new_blocks_per_frame=512, mu_m=0.3),
        stereo=C.StereoMatcherParams(max_disparity=64),
        vo=C.VisualOdometryParams(max_candidates=1024, max_matches=512,
                                  ransac_iters=60, max_disparity=64),
        tracker=C.TrackerParams(min_flow_vectors=8, min_detection_size_px=8),
        decay=C.VoxelDecayParams(enabled=True, min_decay_age=200,
                                 max_decay_weight=1),
    )


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("benchseq") / "seq")
    write_kitti_sequence(root, num_frames=N, width=W, height=H,
                         with_dynamic=True)
    return root


class _Run:
    """What one package's bench mode built, printed and returned."""

    pipe = log = res = None
    stderr = ""

    def __init__(self):
        #: (fused voxels, march samples) of each frame after the warm-up
        self.vox = []

    def tracker_lines(self):
        return [ln for ln in self.stderr.splitlines()
                if ln.startswith("[tracker]")]


def _wrap_build(mp, module, run, after=None, csv=None):
    """Make ``module.build_fused`` keep the pipeline in ``run``, log its
    evaluation's submits, record each static frame's voxel counters and
    call ``after(pipe)``; with ``csv``, write the CSVs there instead of
    the caller's directory."""
    build = module.build_fused

    def build_fused(root, cfg, **kw):
        if csv is not None:
            kw["csv_out_dir"] = csv
        pipe, inp, segp = build(root, cfg, **kw)
        run.pipe, run.log = pipe, SubmitLog(pipe.evaluation)
        if after is not None:
            after(pipe)
        if not cfg.dynamic_mode:
            process = pipe.process_frame
            frames = iter(range(N))

            def process_frame(*args):
                process(*args)
                if next(frames) > tbench.WARMUP:
                    o = pipe.last_outputs
                    run.vox.append((int(o.fused_voxels),
                                    int(o.march_samples)))
            pipe.process_frame = process_frame
        return pipe, inp, segp
    mp.setattr(module, "build_fused", build_fused)


def _run_both(seq, tmp_path_factory, dynamic: bool, argv):
    """(JAX run, port run) of one mode with evaluation on; ``argv`` is
    the flags both read (JAX from ``sys.argv``, the port through its
    parser)."""
    jrun, trun = _Run(), _Run()
    jrun.csv, csv = (str(tmp_path_factory.mktemp(k))
                     for k in ("benchcsv_jax", "benchcsv"))
    with pytest.MonkeyPatch.context() as mp:
        jb = _load_bench()
        # JAX's bench writes its CSVs into a fixed directory under /tmp
        # (bench.py:192, :322) and counts their rows there: both go to
        # this test's own directory instead
        count = jb.count_csv_rows
        mp.setattr(jb, "count_csv_rows",
                   lambda csv_dir, suffix: count(jrun.csv, suffix))
        mp.setattr(jb, "W", W)
        mp.setattr(jb, "H", H)
        mp.setattr(jb, "N_FRAMES", N)
        mp.setattr(jb, "ensure_seq", lambda dynamic: seq)
        mp.setattr(jb, "load_frames",
                   lambda root: tbs.load_frames(root, N, seed=NOISE_SEED))
        mp.setattr(jb, "bench_config",
                   lambda dynamic, k4=False: small_config(jconfig, dynamic))
        mp.setattr(sys, "argv", ["bench.py"] + argv)
        fill = jax_kernel_renders(mp)
        mp.setattr(jfused, "FusedPipeline", _PallasFused)
        mp.setattr(jfd, "FusedDynamicPipeline", _PallasDyn)
        _wrap_build(mp, jbuilder, jrun, csv=jrun.csv)
        main = jb.main_dynamic if dynamic else jb.main_static
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            jrun.res = main(eval_on=True, _timed=False)
        jrun.stderr = err.getvalue()

        def after(pipe):
            key = jrun.pipe.base_key
            pipe.sampler = jax_dynamic_sampler(
                key, pipe.K, pipe.vo_params.ransac_iters,
                pipe.obj_params.ransac_iters) if dynamic else \
                _static_sampler(key, pipe.vo_params.ransac_iters)
        _wrap_build(mp, tbuilder, trun, after)
        args = tbench.parse_args(sys.argv[1:] + ["--cpu", "--frames",
                                                 str(N)])
        main = tbench.main_dynamic if dynamic else tbench.main_static
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            trun.res = main(**tbench.mode_kwargs(args), root=seq,
                            config=small_config(tconfig, dynamic),
                            seed=NOISE_SEED, csv_dir=csv)
        trun.stderr, trun.csv = err.getvalue(), csv
    assert fill and max(fill) < RENDER_CAND_K
    return jrun, trun


def rounds_one_rate(value: float, vs_baseline: float) -> bool:
    """Whether some frame rate ``fps`` gives both ``value == round(fps,
    3)`` and ``vs_baseline == round(fps / 2.5, 3)``, as both benches
    round them. (``round(value / 2.5, 3)`` rounds twice and misses
    ``vs_baseline`` by 0.001 for about one rate in ten.)"""
    lo = max(value - 5e-4, (vs_baseline - 5e-4) * 2.5)
    hi = min(value + 5e-4, (vs_baseline + 5e-4) * 2.5)
    return lo <= hi + 1e-12


@pytest.mark.parametrize("lo", [0.01, 0.1, 1.0])
def test_rounds_one_rate(lo):
    """Every rate's two rounded numbers pass ``rounds_one_rate``; numbers
    that no rate gives fail it."""
    for fps in np.linspace(lo, 10 * lo, 20011):
        assert rounds_one_rate(round(fps, 3), round(fps / 2.5, 3)), fps
        assert not rounds_one_rate(round(fps, 3), round(fps / 2.5, 3) + 0.002)
        assert not rounds_one_rate(round(fps, 3), round(fps / 2.5, 3) - 0.002)


def _check_results(jrun, trun, dynamic: bool) -> None:
    j, t = jrun.res, trun.res
    assert set(t) == set(j) | DEVICE_KEYS
    assert t["device"] == "cpu" and t["power_limit_w"] is None
    for k in ("metric", "unit", "eval_csv_rows") + (
            ("reconstructed_objects", "instance_config") if dynamic else ()):
        assert t[k] == j[k], k
    assert t["eval_csv_rows"] > 0 and t["value"] > 0
    assert rounds_one_rate(t["value"], t["vs_baseline"]), (
        t["value"], t["vs_baseline"])
    check_renders(jrun.log, trun.log)
    compare_csv_dirs(jrun.csv, trun.csv,
                     render_flips(jrun.log, trun.log, trun.pipe.evaluation))
    check_witness(jrun.pipe.evaluation, jrun.log, trun.log, trun.csv)


def test_static_mode_matches_jax(seq, tmp_path_factory):
    jrun, trun = _run_both(seq, tmp_path_factory, False, ["--static",
                                                         "--eval"])
    _check_results(jrun, trun, False)
    assert jrun.res["metric"] == "end_to_end_fps_static_eval_kitti_1242x375"
    assert jrun.res["eval_csv_rows"] == N - 1
    # the static voxel-ops a frame: the voxels of the blocks gated into
    # fusion, equal, plus the samples the raycast marched, which the two
    # packages count by two rules (ops/raycast.py): the port the samples
    # its rays executed, JAX's kernel each tile's steps x 1024 pixels, a
    # bound on the former (measured: 69,151 against 221,184)
    assert len(jrun.vox) == len(trun.vox) == N - tbench.WARMUP - 1
    (printed,) = re.findall(r"M/frame; ([0-9.]+) a frame\)", trun.stderr)
    assert float(printed) == float(np.mean([f + m for f, m in trun.vox]))
    for (jf, jm), (tf, tm) in zip(jrun.vox, trun.vox):
        assert tf == jf and 0 < tm <= jm


@pytest.mark.parametrize("lag", [1, 2])
def test_dynamic_mode_matches_jax(seq, tmp_path_factory, lag):
    argv = ["--dynamic", "--eval", "--verbose"] + (["--lag1"] if lag == 1
                                                   else [])
    jrun, trun = _run_both(seq, tmp_path_factory, True, argv)
    _check_results(jrun, trun, True)
    assert trun.pipe.dispatch_lag == jrun.pipe.dispatch_lag == lag
    assert jrun.res["reconstructed_objects"] == 1
    assert jrun.res["instance_config"] == "K=16 S=8"
    # frames 1 to N - 1 - lag: frame 0 has no map, and after the window
    # both benches call finalize once _finish_prev has finished the last
    # dispatch, so it returns at once and the frames staged for the next
    # lag dispatches are never rendered (bench.py:267-274); chip_smoke.py
    # phase 21 holds the card's 40-frame run to the same count
    assert jrun.res["eval_csv_rows"] == N - 1 - lag
    lines = trun.tracker_lines()
    assert lines == jrun.tracker_lines()
    assert lines == ["[tracker] frame 1 track 0: Uncertain -> Dynamic "
                     "(flow 13, ok True)"]


def test_slot_log_lines_match_jax(capsys):
    """With ``verbose_tracker`` on, a slot's reset and reap print JAX's
    lines (the bench's short scene has neither)."""
    from types import SimpleNamespace

    from dynslam_tpu_torch.pipeline import fused_dynamic as tfd

    out = []
    for module in (jfd, tfd):
        pipe = SimpleNamespace(verbose_tracker=True,
                               _route_reset=np.zeros(4, bool),
                               _route_reap=np.zeros(4, np.float32))
        handle = module._SlotHandle(pipe, 3)
        handle.reset()
        handle.reap(1)
        handle.reap(0.5)
        assert pipe._route_reset[3] and pipe._route_reap[3] == 0.5
        out.append(capsys.readouterr().err)
        pipe.verbose_tracker = False
        handle.reset()
        assert capsys.readouterr().err == ""
    assert out[0] == out[1] == ("[tracker] slot 3: RESET routed\n"
                                "[tracker] slot 3: REAP w<=1\n"
                                "[tracker] slot 3: REAP w<=0.5\n")


# ---------------------------------------------------------------------------
# the dynamic step's pre-uploaded mask planes
# ---------------------------------------------------------------------------


def test_masks_dev_changes_no_output(seq):
    """``process_frame`` with the bench worker's pre-uploaded bit-planes
    (``select_detections``, ``pack_mask_bits``, one ``upload``) against
    the same pipeline packing them itself: every carry word, the packed
    outputs and the tracker's states equal after every frame."""
    cfg = small_config(tconfig, True)
    pipes = [tbuilder.build_fused(seq, cfg, device="cpu")
             for _ in range(2)]
    left, right = tbs.load_frames(seq, N, seed=NOISE_SEED)
    for i in range(N):
        dets = [segp.segment_frame(None).instance_detections
                for _, _, segp in pipes]
        a, b = pipes[0][0], pipes[1][0]
        a.process_frame(left[i], right[i], None, dets[0])
        sel = b.select_detections(dets[1], b.K)
        both = upload(np.stack(b.pack_mask_bits(sel, H, W, b.K)), "cpu")
        b.process_frame(left[i], right[i], None, dets[1],
                        masks_dev=(both[0], both[1]))
        ca = convert.fused_dyn_carry_to_numpy(a.carry)
        cb = convert.fused_dyn_carry_to_numpy(b.carry)
        assert ca.keys() == cb.keys()
        for k in ca:
            assert np.array_equal(np.asarray(ca[k]), np.asarray(cb[k])), \
                (i, k)
        if a.last_outputs is not None:
            assert torch.equal(a.last_outputs.packed, b.last_outputs.packed)
        states = [{t.id: t.state for t in p.tracker.tracks.values()}
                  for p in (a, b)]
        assert states[0] == states[1], i
    assert any(t.has_reconstruction() for t in a.tracker.tracks.values())
