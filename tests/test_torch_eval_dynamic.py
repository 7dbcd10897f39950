"""The dynamic slice with evaluation on, end to end: the port's
``FusedDynamicPipeline`` with ``FusedEvaluation`` attached (CPU, plain
versions of the kernels, the JAX package's RANSAC draws) against the JAX
package's (its Pallas raycast in interpret mode: ``jax_kernel_renders``)
over 7 frames of the ``write_kitti_sequence(with_dynamic=True)`` scene at
240x160, with tests/test_fused_eval.py's 112x160 crop (the evaluation
renders the car in a crop viewport), at dispatch lag 1 (lag 2:
``test_torch_eval_dynamic_lag2.py``); and the crop viewport against the
full-frame render."""

import dataclasses
import os

import numpy as np
import pytest

from dynslam_tpu.config import (
    EvaluationParams, InstanceMapParams, Intrinsics, StereoCalibration,
)
import dynslam_tpu.pipeline.fused_dynamic as jfd
from dynslam_tpu.io import segmentation as jseg
from dynslam_tpu_torch.eval.evaluation import ASSOC_DYNAMIC
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.pipeline.builder import (
    attach_evaluation, build_fused_dynamic,
)

from test_dynamic_pipeline import dynamic_config
from test_torch_eval import to_port
from test_torch_eval_slice import (
    SliceRun, SubmitLog, _rows, check_fill, check_renders, check_witness,
    compare_csv_dirs, render_flips, unified,
)
from torch_frontend_inputs import (
    jax_dynamic_sampler, jax_fused_evaluation, jax_kernel_renders,
    write_eval_sequence,
)
from torch_threads import threads

torch_threads = threads(2)

W, H, N_FRAMES = 240, 160, 7
INTR = Intrinsics(0.8 * W, 0.8 * W, W / 2.0, H / 2.0)
_base = dynamic_config()
#: max_depth 15 m keeps every render under 16.384 m, past which the JAX
#: package's packed lookup reads the rendered depth back wrong; 48 fine
#: steps (the march takes 60) let the rays reach the far road and
#: buildings. The object volumes' mu is 0.3 m, not the reference's 1 m:
#: the car's motion estimates differ between the packages by float order
#: (up to 1e-4 here), and at mu = 1 m the march's sphere steps (up to 0.9
#: mu) cross the thin object or stop on it by the pose, so the car's
#: render moves far more than its pose; at 0.3 m the packages' renders
#: part at a point or two.
CFG = _base.replace(
    frame_width=W, frame_height=H, intrinsics=INTR, right_intrinsics=INTR,
    calibration=StereoCalibration(0.5, INTR.fx), max_depth_m=15.0,
    map=dataclasses.replace(_base.map, raycast_coarse_steps=24,
                            raycast_fine_steps=48),
    instance_map=InstanceMapParams(
        mu_m=0.3, blocks_per_object=1024, local_dims=(48, 24, 64),
        max_new_blocks_per_frame=512, max_detections=8,
        fusion_crop=(112, 160)),
    evaluation=EvaluationParams(enabled=True, semantic_evaluation=True))
#: the car's render poses (cam-to-volume matrices) agree to this
#: (measured: 5.4e-4 at lag 1, 1.5e-3 at lag 2)
MAX_POSE_GAP = 5e-3


class StashLog:
    """Wraps a pipeline's ``_stash_eval``: records each evaluated frame's
    track states and object render poses as the stash sees them."""

    def __init__(self, pipe):
        self.fn, self.pipe, self.states = pipe._stash_eval, pipe, {}
        self.poses = {}
        pipe._stash_eval = self

    def __call__(self, frame_no, *args, **kw):
        self.states[frame_no] = {t.id: t.state.value for t in
                                 self.pipe.tracker.active_tracks.values()}
        out = self.fn(frame_no, *args, **kw)
        vol_c2w, active = self.pipe._eval_pending[4:6]
        self.poses[frame_no] = vol_c2w[active]
        return out


def run_lag(tmp_path_factory, lag) -> SliceRun:
    """Both pipelines over the frames at dispatch lag ``lag``, then
    finalize and close (``stash``: the stash logs, JAX and port)."""
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        out = _run_lag(tmp_path_factory, lag)
    # a copy: the next run in this process empties the shared list
    out.fill = list(fill)
    return out


def _run_lag(tmp_path_factory, lag) -> SliceRun:
    root = str(tmp_path_factory.mktemp(f"evaldyn{lag}") / "seq")
    frames = write_eval_sequence(root, CFG, N_FRAMES, dynamic=True)
    jdir, tdir = (str(tmp_path_factory.mktemp(f"{k}{lag}"))
                  for k in ("jax", "port"))
    jp = jfd.FusedDynamicPipeline(CFG, CFG.calibration, use_pallas=True,
                                  dispatch_lag=lag)
    jp.evaluation = jax_fused_evaluation(root, CFG, jdir)
    pcfg = to_port(CFG)
    tp = build_fused_dynamic(pcfg, pcfg.calibration, device="cpu",
                             dispatch_lag=lag)
    tp.sampler = jax_dynamic_sampler(jp.base_key, tp.K, CFG.vo.ransac_iters,
                                     CFG.tracker.object_ransac_iters)
    attach_evaluation(tp, pcfg, root, csv_out_dir=tdir)
    logs = StashLog(jp), StashLog(tp)
    renders = SubmitLog(jp.evaluation), SubmitLog(tp.evaluation)
    for lg, rg, rgb, objid in frames:
        jp.process_frame(lg, rg, rgb, jseg.detections_from_instance_ids(
            objid, min_size_px=8, score=0.98))
        tp.process_frame(lg, rg, rgb, tseg.detections_from_instance_ids(
            objid, min_size_px=8, score=0.98))
    for pipe in (jp, tp):
        pipe.finalize()
        pipe.evaluation.close()
    return SliceRun(jdir, tdir, tp, jp.evaluation, renders, [],
                    render_flips(*renders, tp.evaluation), logs)


#: the regions ``check_renders`` compares: the frame, and the pixels the
#: association map gives the dynamic objects
REGIONS = [None, ASSOC_DYNAMIC]
REGION_IDS = ["frame", "dynamic"]


def check_dynamic_run(run: SliceRun):
    """The CSVs against JAX's, every dispatched frame evaluated, crop
    renders, a dynamic bucket with fused hits, and the boundary case."""
    tdir, tp, (jlog, tlog) = run.tdir, run.tp, run.stash
    compare_csv_dirs(run.jdir, tdir, run.flips)
    assert tlog.poses.keys() == jlog.poses.keys(), (
        sorted(tlog.poses), sorted(jlog.poses))
    for f, poses in tlog.poses.items():
        assert poses.shape == jlog.poses[f].shape, (
            f, poses.shape, jlog.poses[f].shape)
        gap = float(np.abs(poses - jlog.poses[f]).max(initial=0))
        assert gap <= MAX_POSE_GAP, (
            f"frame {f}: the car's render poses part by {gap} (bound "
            f"{MAX_POSE_GAP})")
    # lag 1 and 2 evaluate the same frames: every dispatched one
    assert sorted(unified(tdir)) == list(range(1, N_FRAMES)), sorted(
        unified(tdir))
    assert tp.eval_crop_renders > 0, tp.eval_crop_renders
    (name,) = [n for n in os.listdir(tdir)
               if n.endswith("-dynamic-depth-result.csv")]
    rows = {int(r["frame"]): r
            for r in _rows(open(os.path.join(tdir, name)).read())}
    tot = sum(int(r["fusion-total-3.00"]) for r in rows.values())
    hit = sum(int(r["fusion-total-3.00"]) - int(r["fusion-missing-3.00"])
              for r in rows.values())
    assert tot > 0 and hit > 0, (tot, hit)
    # the boundary case: the car is certified Dynamic on the first
    # evaluated frame in both packages, and that frame's points already
    # go to the dynamic bucket (its totals equal JAX's: compare_csv_dirs)
    first = [f for f, s in tlog.states.items() if "Dynamic" in s.values()]
    assert tlog.states == jlog.states, (tlog.states, jlog.states)
    assert first and int(rows[min(first)]["input-total-3.00"]) > 0, (
        first, tlog.states)


@pytest.fixture(scope="module")
def lag1(tmp_path_factory) -> SliceRun:
    return run_lag(tmp_path_factory, 1)


def test_dynamic_lag1_render_candidates_fit(lag1):
    check_fill(lag1.fill)


@pytest.mark.parametrize("region", REGIONS, ids=REGION_IDS)
def test_dynamic_lag1_renders_agree(lag1, region):
    check_renders(*lag1.renders, region=region)


def test_dynamic_lag1_witness_rows(lag1):
    check_witness(lag1.jax_eval, *lag1.renders, lag1.tdir)


def test_dynamic_slice_lag1_csvs_match_jax(lag1):
    check_dynamic_run(lag1)


def test_crop_viewport_equals_full_frame(lag1):
    """The car's volume rendered into a crop viewport (principal point
    shifted by the crop origin) equals the full-frame render on the
    crop's window (``raycast_ref``): the same rays, up to the rounding of
    the shifted principal point."""
    tp = lag1.tp
    (t,) = [t for t in tp.tracker.active_tracks.values()
            if t.has_reconstruction()]
    k = len(t.frames) - 1
    c2w = np.linalg.inv(tp.pose_history[-1] @ np.linalg.inv(
        t.frames[k].camera_pose) @ t.get_frame_pose(k)).astype(np.float32)
    bb = t.frames[k].detection.copy_mask.bbox
    ch, cw = tp.crop_h, tp.crop_w
    u0 = min(max(int((bb.x0 + bb.x1) * 0.5) - cw // 2, 0), W - cw)
    v0 = min(max(int((bb.y0 + bb.y1) * 0.5) - ch // 2, 0), H - ch)
    assert (u0, v0) != (0, 0)
    crop = tp.render_instance_crop(t.reconstruction.slot, c2w, u0, v0)
    full = tp.raycast_instance(t.reconstruction.slot, c2w)
    assert crop.depth.shape == (ch, cw)
    win = (slice(v0, v0 + ch), slice(u0, u0 + cw))
    fh, fd = full.hit[win], full.depth[win]
    assert int(fh.sum()) > 200
    assert (crop.hit == fh).double().mean() >= 0.999
    both = crop.hit & fh
    assert (crop.depth - fd).abs()[both].max() <= 1e-4
