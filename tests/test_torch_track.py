"""The port's host tracker (``dynslam_tpu_torch/instances/``) against the
JAX package's on scripted detections with precomputed object motions:
identical track ids, states, relative and chain poses, slot resets and
reap weights, through Uncertain -> Dynamic, the Static snap, the
constant-velocity hold and the fall back to Uncertain, and pruning."""

import numpy as np
import pytest

from dynslam_tpu.config import TrackerParams as JaxParams
from dynslam_tpu.instances.track import TrackFrame as JaxFrame
from dynslam_tpu.instances.tracker import InstanceTracker as JaxTracker
from dynslam_tpu.io import segmentation as jseg
from dynslam_tpu_torch.config import TrackerParams
from dynslam_tpu_torch.instances.track import TrackFrame
from dynslam_tpu_torch.instances.tracker import InstanceTracker
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.utils.se3 import np_twist_to_transform


class Recon:
    """A volume stand-in that records what the track asks of it."""

    def __init__(self, log):
        self.log = log

    def reset(self):
        self.log.append("reset")

    def reap(self, w):
        self.log.append(("reap", w))

    def release(self):
        self.log.append("release")


def _det(seg, x0, cls=7, score=0.98):
    objid = np.zeros((60, 200), np.int16)
    objid[20:44, x0: x0 + 30] = 1
    (d,) = seg.detections_from_instance_ids(objid, min_size_px=8,
                                            score=score)
    d.class_id = cls
    return d


#: per frame: (object x0, motion) for the two objects A (moving) and B
#: (parked); a motion is a twist, or None for "the device's RANSAC failed"
MOVE = np.array([0.01, -0.02, 0.003, 0.1, 0.0, 0.9])  # 0.9 m a frame
PARK = np.array([0.0, 0.0, 0.0, 0.004, 0.0, -0.78])  # cancels egomotion
SCRIPT = [
    {"A": (10, MOVE), "B": (120, PARK)},   # first frames: no association
    {"A": (12, MOVE), "B": (120, PARK)},   # A -> Dynamic, B -> Static
    {"A": (14, None), "B": (121, PARK)},   # A: constant-velocity hold
    {"A": (16, None), "B": (121, None)},   # A: age 2 > 1 -> Uncertain
    {"A": (18, MOVE), "B": (122, None)},   # A -> Dynamic again (reset)
    {"B": (122, None)},                    # A missed: nothing to update
    {"A": (22, MOVE), "B": (123, None)},   # B: hold up to 5 frames
    {"A": (24, MOVE), "B": (123, None)},
    {"A": (26, MOVE), "B": (124, None)},   # B: age 6 > 5 -> Uncertain
]
EGO = np.eye(4)
EGO[2, 3] = 0.78  # the camera's delta T_cur<-prev


def _motion(tr):
    if tr is None:
        return None, None
    return np_twist_to_transform(tr), tr.copy()


def test_tracker_matches_jax():
    sides = {
        "jax": (JaxTracker(JaxParams(min_flow_vectors=8)), jseg, JaxFrame),
        "port": (InstanceTracker(TrackerParams(min_flow_vectors=8)), tseg,
                 TrackFrame),
    }
    logs = {k: {} for k in sides}
    history = {k: [] for k in sides}
    for f, objs in enumerate(SCRIPT, start=1):
        for name, (tracker, seg, Frame) in sides.items():
            frames = {o: Frame(frame_idx=f, detection=_det(seg, x0),
                               masked_flow=np.zeros((0, 8), np.float32),
                               camera_pose=np.eye(4))
                      for o, (x0, _) in objs.items()}
            tracker.process_instance_views(f, list(frames.values()))
            for o, (_, tr) in objs.items():
                track = next(t for t in tracker.active_tracks.values()
                             if t.frames[-1] is frames[o])
                if f == 1:
                    # a volume from the start, so state changes reset it
                    log = logs[name].setdefault(track.id, [])
                    track.reconstruction = Recon(log)
                frames[o].precomputed_motion = _motion(tr)
                track.update(EGO, None, frame=frames[o])
            history[name].append({
                t.id: (t.state.value, len(t.frames),
                       [None if fr.relative_pose is None
                        else np.asarray(fr.relative_pose).round(12).tolist()
                        for fr in t.frames],
                       np.asarray(t.get_frame_pose(len(t.frames) - 1))
                       .round(12).tolist())
                for t in tracker.active_tracks.values()})
    assert history["port"] == history["jax"]
    states = [{tid: v[0] for tid, v in h.items()} for h in history["port"]]
    assert states[1] == {0: "Dynamic", 1: "Static"}
    assert states[2] == {0: "Dynamic", 1: "Static"}  # hold
    assert states[3] == {0: "Uncertain", 1: "Static"}
    assert states[4][0] == "Dynamic"
    assert states[7][1] == "Static" and states[8][1] == "Uncertain"
    assert logs["port"] == logs["jax"]
    assert "reset" in logs["port"][0]

    # reap weights: max(1, min(3, int(0.33 * fused))) on both
    for name, (tracker, *_rest) in sides.items():
        for fused in (0, 3, 6, 9, 12):
            for t in tracker.active_tracks.values():
                t.fused_frames = fused
                t.reap_reconstruction()
    assert logs["port"] == logs["jax"]
    assert ("reap", 3.0) in logs["port"][0] and ("reap", 1.0) in logs["port"][0]

    # pruning after 50 inactive frames releases the volume
    for name, (tracker, *_rest) in sides.items():
        tracker.prune_tracks(len(SCRIPT) + 51)
        assert not tracker.active_tracks
    assert logs["port"] == logs["jax"]
    assert logs["port"][0][-1] == "release"


def test_score_match_matches_jax():
    """IoU x probabilities x the time discount, class-gated."""
    def frame(seg, Frame, f, x0, cls=7, score=0.9):
        return Frame(frame_idx=f, detection=_det(seg, x0, cls, score),
                     masked_flow=np.zeros((0, 8)), camera_pose=np.eye(4))

    for gap in (0, 1, 2, 3):
        scores = []
        for Tracker, Params, seg, Frame in (
                (JaxTracker, JaxParams, jseg, JaxFrame),
                (InstanceTracker, TrackerParams, tseg, TrackFrame)):
            tracker = Tracker(Params())
            tracker.process_instance_views(1, [frame(seg, Frame, 1, 10)])
            (t,) = tracker.active_tracks.values()
            scores.append([t.score_match(frame(seg, Frame, 1 + gap, x0, c))
                           for x0 in (10, 18, 60) for c in (7, 6)])
        assert scores[0] == scores[1]


def test_update_without_motion_refuses():
    """A frame with neither a precomputed motion nor a scene-flow provider
    to estimate one."""
    tracker = InstanceTracker(TrackerParams())
    tf = TrackFrame(1, _det(tseg, 10), np.zeros((0, 8)), np.eye(4))
    tracker.process_instance_views(1, [tf])
    (t,) = tracker.active_tracks.values()
    with pytest.raises(ValueError, match="scene-flow provider"):
        t.update(EGO, None, frame=tf)


class ScriptedSF:
    """A scene-flow provider stand-in: ``extract_motion`` returns the next
    scripted twist (None = failure) and records its calls."""

    def __init__(self, twists):
        self.twists, self.calls = list(twists), []

    def extract_motion(self, flow, initial, irls_rounds=None, gn_iters=None):
        self.calls.append((len(flow), None if initial is None
                           else np.asarray(initial).tolist(), irls_rounds,
                           gn_iters))
        tr = self.twists.pop(0)
        return None if tr is None else np.asarray(tr, np.float32)


def test_staged_estimator_matches_jax():
    """The staged path's ``update(egomotion, sf_provider)``: the masked
    flow's estimate (warm-started from the previous frame's twist, with the
    object IRLS/GN depths, skipped under ``min_flow_vectors``) drives the
    same states and poses as in the JAX package."""
    twists = [[0.0, 0.01, 0.0, 0.9, 0.0, 0.1], None,
              [0.0, 0.0, 0.0, 0.01, 0.0, 0.0], [0.0, 0.0, 0.0, 0.7, 0, 0]]
    flows = [np.zeros((30, 8)), np.zeros((30, 8)), np.zeros((3, 8)),
             np.zeros((30, 8)), np.zeros((30, 8))]
    out = []
    for frame_cls, seg, params, tracker_cls in (
            (JaxFrame, jseg, JaxParams(), JaxTracker),
            (TrackFrame, tseg, TrackerParams(), InstanceTracker)):
        tracker = tracker_cls(params)
        sf = ScriptedSF(twists)
        log = []
        for f, flow in enumerate(flows):
            tf = frame_cls(f, _det(seg, 10 + 2 * f), flow, np.eye(4))
            tracker.process_instance_views(f, [tf])
            (t,) = tracker.active_tracks.values()
            t.update(EGO, sf)
            log.append((t.state.value, None if tf.relative_pose is None
                        else np.round(np.asarray(tf.relative_pose), 5)))
        out.append((log, sf.calls))
    (jlog, jcalls), (tlog, tcalls) = out
    assert tcalls == jcalls
    for (js, jp), (ts, tp) in zip(jlog, tlog):
        assert js == ts
        assert (jp is None) == (tp is None)
        if jp is not None:
            np.testing.assert_allclose(tp, jp, atol=1e-5)
    assert {s for s, _ in tlog} >= {"Dynamic"}
