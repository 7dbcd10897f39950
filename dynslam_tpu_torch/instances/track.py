"""Per-object Track: frame list, motion bookkeeping, and the
Uncertain/Static/Dynamic state machine — a numpy copy of
``dynslam_tpu/instances/track.py``.

Mirrors `src/DynSLAM/InstRecLib/Track.{h,cpp}` semantics:
- match scoring = bbox IoU x class-prob product x time discount
  (Track.cpp:17-71)
- 3-state machine driven by the translational magnitude of
  (egomotion o object-motion): > 0.550 m -> Dynamic, < 0.030 m -> Static
  (motion snapped to identity); Static/Dynamic fall back to Uncertain
  after 5/1 frames without a motion estimate, with constant-velocity
  hold for smaller gaps (Track.cpp:246-342)
- relative-pose chain product for fusion poses, restarting after gaps
  (Track.cpp:90-118); ReapReconstruction weight min(3, max(1, 0.33*fused))
  (Track.h:222-229)

The object motion arrives precomputed (``TrackFrame.precomputed_motion``,
set by the fused dynamic step's per-mask RANSAC on the device) or, on the
staged path, from the scene-flow provider's ``extract_motion`` on the
frame's masked flow, warm-started from the previous frame's twist, with at
least ``min_flow_vectors`` vectors (Track.cpp:167-209).

Pose conventions: `relative_pose` is the estimator's T_cur<-prev for the
object's flow, chained as chain_k = rel_k @ chain_{k-1}. The object
volume's frame is the camera frame of its first fused frame; fusing frame
k sets the volume's world-to-cam pose to chain_k.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from dynslam_tpu_torch.config import TrackerParams
from dynslam_tpu_torch.io.segmentation import InstanceDetection
from dynslam_tpu_torch.utils.se3 import twist_to_transform


class TrackState(enum.Enum):
    UNCERTAIN = "Uncertain"
    STATIC = "Static"
    DYNAMIC = "Dynamic"


@dataclass
class TrackFrame:
    frame_idx: int
    detection: InstanceDetection
    #: masked scene-flow rows (M, 8), host numpy (RawFlow layout)
    masked_flow: np.ndarray
    #: world-to-camera pose of the frame (pipeline pose chain entry)
    camera_pose: np.ndarray
    #: device views of the cut-out object (set at silhouette processing,
    #: staged path)
    instance_rgb: object = None
    instance_depth_m: object = None
    #: object motion: T_cur<-prev (None = unknown)
    relative_pose: Optional[np.ndarray] = None
    relative_pose_tr: Optional[np.ndarray] = None
    #: egomotion @ relative_pose (world-frame error/eval form)
    relative_pose_world: Optional[np.ndarray] = None
    #: (T 4x4, tr 6) from the device's per-mask RANSAC; (None, None) =
    #: the device ran and failed
    precomputed_motion: object = None


def _translation_norm(T: np.ndarray) -> float:
    return float(np.linalg.norm(T[:3, 3]))


class Track:
    def __init__(self, track_id: int, params: TrackerParams):
        self.id = track_id
        self.params = params
        self.frames: List[TrackFrame] = []
        self.reconstruction = None  # a pooled volume, an engine or None
        self.state = TrackState.UNCERTAIN
        self.needs_cleanup = False
        self.fused_frames = 0
        self._last_known_motion: Optional[np.ndarray] = None
        self._last_known_motion_tr: Optional[np.ndarray] = None
        self._last_known_motion_world: Optional[np.ndarray] = None
        self._last_known_motion_time = -1

    # -- basic accessors --------------------------------------------------
    @property
    def last_frame(self) -> TrackFrame:
        return self.frames[-1]

    @property
    def class_name(self) -> str:
        return self.last_frame.detection.class_name

    @property
    def end_time(self) -> int:
        return self.frames[-1].frame_idx

    def add_frame(self, frame: TrackFrame) -> None:
        self.frames.append(frame)

    def has_reconstruction(self) -> bool:
        return self.reconstruction is not None

    def eligible_for_reconstruction(self) -> bool:
        """Need at least two frames to have relative motion."""
        return len(self.frames) >= 2

    # -- association scoring (Track.cpp:17-71) ----------------------------
    def score_match(self, new_frame: TrackFrame) -> float:
        latest = self.last_frame
        delta_time = new_frame.frame_idx - self.end_time
        if delta_time == 0:
            return 0.0
        nd, ld = new_frame.detection, latest.detection
        if nd.class_id != ld.class_id:
            return 0.0
        iou = ld.copy_mask.bbox.iou(nd.copy_mask.bbox)
        score = iou * nd.class_probability * ld.class_probability
        if delta_time == 2:
            score *= 0.5
        elif delta_time > 2:
            score *= 0.25
        return score

    # -- motion + state machine (Track.cpp:167-343) -----------------------
    def _estimate_instance_motion(self, sf_provider, initial_estimate,
                                  frame: TrackFrame):
        """(T 4x4 float64, twist) of the frame's object motion, or (None,
        None): the precomputed motion when the frame has one, else the
        staged path's estimate from its masked flow."""
        if frame.precomputed_motion is not None:
            return frame.precomputed_motion
        if sf_provider is None:
            raise ValueError("Track.update: a frame without precomputed "
                             "motion needs a scene-flow provider")
        flow = frame.masked_flow
        if len(flow) < self.params.min_flow_vectors:
            return None, None
        tr = sf_provider.extract_motion(
            flow, initial_estimate,
            irls_rounds=self.params.object_irls_rounds,
            gn_iters=self.params.object_gn_iters)
        if tr is None:
            return None, None
        # float32, as the JAX package's se3.twist_to_transform, widened
        T = twist_to_transform(torch.tensor(tr, dtype=torch.float32))
        return T.double().numpy(), tr

    def update(self, egomotion: np.ndarray, sf_provider=None,
               frame: "Optional[TrackFrame]" = None) -> None:
        """Estimate or take this frame's object motion and advance the
        state machine. `egomotion` is the camera delta T_cur<-prev. `frame`
        targets a specific TrackFrame (default: the latest) — the fused
        lag-2 protocol finishes a frame after a newer one is already
        associated. `sf_provider` (the staged path's ``SparseSFProvider``)
        estimates the motion of a frame without a precomputed one."""
        frame = frame if frame is not None else self.last_frame
        current_frame_idx = frame.frame_idx

        # warm start from the previous frame's twist (Track.cpp:216-232)
        initial = None
        if len(self.frames) >= 2 and \
                self.frames[-2].relative_pose_tr is not None:
            initial = self.frames[-2].relative_pose_tr
        delta, delta_tr = self._estimate_instance_motion(sf_provider, initial,
                                                         frame)
        if delta is not None:
            frame.relative_pose = delta
            frame.relative_pose_tr = delta_tr
            frame.relative_pose_world = egomotion @ delta

        if self.state == TrackState.UNCERTAIN:
            if delta is not None:
                error = egomotion @ delta
                trans_error = _translation_norm(error)
                old_state = self.state
                if trans_error > self.params.trans_error_threshold_high:
                    self.state = TrackState.DYNAMIC
                elif trans_error < self.params.trans_error_threshold_low:
                    # stationary: snap the motion to identity
                    frame.relative_pose = np.eye(4)
                    frame.relative_pose_tr = np.zeros(6)
                    frame.relative_pose_world = np.eye(4)
                    self.state = TrackState.STATIC
                self._last_known_motion = frame.relative_pose
                self._last_known_motion_tr = frame.relative_pose_tr
                self._last_known_motion_world = frame.relative_pose_world
                self._last_known_motion_time = current_frame_idx

                if self.state != old_state and self.has_reconstruction():
                    # (stat/dyn) -> uncertain -> (stat/dyn): cannot register
                    # to the old volume, start fresh (Track.cpp:290-300)
                    self.reconstruction.reset()
                    self.fused_frames = 0
        else:
            threshold = (
                self.params.max_uncertain_frames_static
                if self.state == TrackState.STATIC
                else self.params.max_uncertain_frames_dynamic
            )
            if delta is not None:
                if self.state == TrackState.STATIC:
                    # static: motion is identity by definition
                    frame.relative_pose = np.eye(4)
                    frame.relative_pose_tr = np.zeros(6)
                    frame.relative_pose_world = np.eye(4)
                    self._last_known_motion = np.eye(4)
                    self._last_known_motion_tr = np.zeros(6)
                    self._last_known_motion_world = np.eye(4)
                else:
                    self._last_known_motion = delta
                    self._last_known_motion_tr = delta_tr
                    self._last_known_motion_world = frame.relative_pose_world
                self._last_known_motion_time = current_frame_idx
            else:
                motion_age = current_frame_idx - self._last_known_motion_time
                if motion_age > threshold:
                    self.state = TrackState.UNCERTAIN
                else:
                    # constant-velocity hold for small gaps
                    frame.relative_pose = self._last_known_motion
                    frame.relative_pose_tr = self._last_known_motion_tr
                    frame.relative_pose_world = self._last_known_motion_world

    # -- pose chains (Track.cpp:90-165) -----------------------------------
    def get_frame_pose(self, frame_idx: int) -> Optional[np.ndarray]:
        """Chain product of relative poses up to frames[frame_idx], in the
        object-volume frame; restarts after pose gaps."""
        assert frame_idx < len(self.frames)
        found_good = False
        pose = np.eye(4)
        for i in range(1, frame_idx + 1):
            rel = self.frames[i].relative_pose
            if rel is not None:
                found_good = True
                pose = rel @ pose
            elif found_good:
                found_good = False
                pose = np.eye(4)
        return pose

    def get_frame_camera_pose(self, frame_idx: int):
        """(camera world-to-camera pose of frames[frame_idx], its chain):
        the volume's world transform is C2W_k @ chain_k."""
        return self.frames[frame_idx].camera_pose, \
            self.get_frame_pose(frame_idx)

    def get_first_fusable_frame_index(self) -> int:
        """Index right before the first frame with a known relative pose,
        -1 if none (Track.h:203-216)."""
        for i, f in enumerate(self.frames):
            if f.relative_pose is not None:
                return max(0, i - 1)
        return -1

    # -- reconstruction bookkeeping ---------------------------------------
    def count_fused_frame(self) -> None:
        self.fused_frames += 1

    def reap_reconstruction(self) -> None:
        """Aggressive decay when the track goes stale (Track.h:222-229)."""
        reap_weight = max(1, min(3, int(0.33 * self.fused_frames)))
        if self.reconstruction is not None:
            self.reconstruction.reap(float(reap_weight))

    def release_reconstruction(self) -> None:
        # a pool slot goes back to its pool; a standalone engine has none
        if hasattr(self.reconstruction, "release"):
            self.reconstruction.release()
        self.reconstruction = None

    def __repr__(self):
        return (
            f"Track(#{self.id}, {self.class_name}, {self.state.value}, "
            f"{len(self.frames)} frames, rec={self.has_reconstruction()})"
        )
