"""The port's tracklet reader (``io/tracklets.py``) and tracking evaluation
(``eval/tracking_eval.py``) against the JAX package's on the same inputs:
the ``tracklets.txt`` the port's ``write_kitti_sequence`` writes, read by
both (records equal field for field), and the records and CSV rows of
both evaluations over the same tracks and camera poses (equal exactly:
both are host numpy in float64)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from dynslam_tpu.eval import tracking_eval as jte
from dynslam_tpu.io import segmentation as jseg
from dynslam_tpu.io import tracklets as jtr
from dynslam_tpu_torch.eval import tracking_eval as tte
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.io import tracklets as ttr
from dynslam_tpu_torch.io.calib import read_kitti_poses
from dynslam_tpu_torch.io.synthetic import write_kitti_sequence

N = 5


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trk"))
    write_kitti_sequence(root, num_frames=N, width=160, height=120,
                         with_dynamic=True)
    return root


def _fields(t):
    return (t.frame, t.track_id, t.type, t.truncated, t.occlusion_level,
            t.alpha, t.bbox_2d, tuple(t.dimensions_m),
            tuple(t.location_cam_m), t.rotation_y)


@pytest.mark.parametrize("cars_only", [True, False])
def test_tracklets_equal(seq, cars_only):
    path = os.path.join(seq, "tracklets.txt")
    want = jtr.read_grouped_tracklets(path, cars_only)
    got = ttr.read_grouped_tracklets(path, cars_only)
    assert sorted(got) == sorted(want) and len(got) >= N - 1
    for f in want:
        assert [_fields(t) for t in got[f]] == [_fields(t) for t in want[f]]
    t = got[1][0]
    assert t.type == "Car" and t.location_cam_m[2] > 3.0


def test_unknown_type_raises(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("0 1 Spaceship 0 0 0 1 2 3 4 1 1 1 0 0 5 0\n")
    with pytest.raises(ValueError, match="Spaceship"):
        ttr.read_tracklets(str(p))


def _dyn(seg, grouped, poses_c2w, rng):
    """A pipeline as the evaluation reads it: one track a ground-truth car
    whose last frame is the sequence's last, its detection box the
    tracklet's (shifted 1 px), its motion a random shift of a few cm."""
    f = N - 1
    tracks = {}
    for k, t in enumerate(grouped[f]):
        x0, y0, x1, y1 = (int(v) for v in t.bbox_2d)
        det = SimpleNamespace(copy_mask=SimpleNamespace(
            bbox=seg.BoundingBox(x0 + 1, y0, x1 + 1, y1)))
        motion = np.eye(4)
        motion[:3, 3] = rng.normal(0, 0.05, 3)
        tracks[k] = SimpleNamespace(id=10 + k, last_frame=SimpleNamespace(
            frame_idx=f, detection=det, relative_pose_world=motion))
    rec = SimpleNamespace(tracker=SimpleNamespace(active_tracks=tracks))
    history = [np.eye(4)] + [np.linalg.inv(p) for p in poses_c2w]
    return SimpleNamespace(instance_reconstructor=rec, pose_history=history)


def test_records_and_csv_equal(seq, tmp_path):
    path = os.path.join(seq, "tracklets.txt")
    poses = read_kitti_poses(os.path.join(seq, "ground-truth-poses.txt"))
    out = []
    for te, tr, seg in ((jte, jtr, jseg), (tte, ttr, tseg)):
        grouped = tr.read_grouped_tracklets(path)
        csv = str(tmp_path / f"{te.__name__}.csv")
        ev = te.TrackingEvaluation(grouped, csv_path=csv)
        dyn = _dyn(seg, grouped, poses, np.random.default_rng(4))
        recs = ev.evaluate_frame(dyn, N - 1)
        assert ev.evaluate_frame(dyn, 0) == []  # no previous frame
        ev.close()
        out.append((recs, open(csv).read()))
    (rj, cj), (rt, ct) = out
    assert len(rt) >= 1
    assert [(r.frame_id, r.track_id, r.trans_error, r.rot_error)
            for r in rt] == [(r.frame_id, r.track_id, r.trans_error,
                              r.rot_error) for r in rj]
    assert ct == cj and ct.startswith("frame_id,track_id,trans_error,"
                                      "rot_error\n")
    assert all(r.trans_error > 0.0 and np.isfinite(r.rot_error)
               for r in rt)


def test_tracklet_pose_matches_jax(seq):
    for t in jtr.read_tracklets(os.path.join(seq, "tracklets.txt")):
        assert np.array_equal(jte._tracklet_pose_cam(t),
                              tte.tracklet_pose_cam(t))


def test_no_ground_truth_no_records(seq):
    poses = read_kitti_poses(os.path.join(seq, "ground-truth-poses.txt"))
    grouped = ttr.read_grouped_tracklets(os.path.join(seq, "tracklets.txt"))
    dyn = _dyn(tseg, grouped, poses, np.random.default_rng(0))
    assert tte.TrackingEvaluation({}).evaluate_frame(dyn, N - 1) == []
