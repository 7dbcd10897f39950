"""3-D object-tracking evaluation against KITTI tracklets — the port of
``dynslam_tpu/eval/tracking_eval.py`` (the reference's tracklet evaluation,
Evaluation.cpp:358-433, and its TrackletEvaluation record). The reference
turns it off in its final runs (``eval_tracklets_(false)``,
Evaluation.h:193-197); like the JAX package, the port has it as a library
path with no CLI flag.

Per frame, each active track's estimated object motion
(``relative_pose_world``, the frame-to-frame motion in the previous
camera's frame) is compared with the motion the tracklets give (the
object's camera-frame location and rotation about y, carried through the
camera pose chain). A track is matched to the tracklet whose 2-D box has
the largest IoU with its detection's. The errors follow the KITTI
convention: |t_est - t_gt| of the delta, and the angle of R_est R_gt^T.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from dynslam_tpu_torch.eval.csv_writer import CsvWriter
from dynslam_tpu_torch.eval.records import TrackletEvaluation
from dynslam_tpu_torch.io.segmentation import BoundingBox
from dynslam_tpu_torch.io.tracklets import TrackletFrame


def tracklet_pose_cam(t: TrackletFrame) -> np.ndarray:
    """Object-to-camera transform of a tracklet (rotation about cam y)."""
    c, s = np.cos(t.rotation_y), np.sin(t.rotation_y)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[:3, 3] = t.location_cam_m
    return T


def _bbox_iou(a: BoundingBox, tb) -> float:
    return a.iou(BoundingBox(int(tb[0]), int(tb[1]), int(tb[2]), int(tb[3])))


class TrackingEvaluation:
    def __init__(self, grouped_tracklets: Dict[int, List[TrackletFrame]],
                 csv_path: Optional[str] = None, min_iou: float = 0.5):
        self.gt = grouped_tracklets
        self.min_iou = min_iou
        self.csv = CsvWriter(csv_path) if csv_path else None
        self.results: List[TrackletEvaluation] = []

    def _match_gt(self, det_bbox: BoundingBox, frame_idx: int):
        best, best_iou = None, self.min_iou
        for t in self.gt.get(frame_idx, []):
            iou = _bbox_iou(det_bbox, t.bbox_2d)
            if iou > best_iou:
                best, best_iou = t, iou
        return best

    def evaluate_frame(self, dyn_slam, frame_idx: int
                       ) -> List[TrackletEvaluation]:
        """Every active track with a motion estimate at ``frame_idx``
        (needs the poses of frames ``frame_idx - 1`` and ``frame_idx``)."""
        out: List[TrackletEvaluation] = []
        recon = dyn_slam.instance_reconstructor
        if recon is None or frame_idx < 1:
            return out
        c2w_cur = np.linalg.inv(dyn_slam.pose_history[frame_idx + 1])
        c2w_prev = np.linalg.inv(dyn_slam.pose_history[frame_idx])
        for track in recon.tracker.active_tracks.values():
            lf = track.last_frame
            if lf.frame_idx != frame_idx or lf.relative_pose_world is None:
                continue
            gt_cur = self._match_gt(lf.detection.copy_mask.bbox, frame_idx)
            if gt_cur is None:
                continue
            # the same ground-truth track's previous observation
            gt_prev = next((t for t in self.gt.get(frame_idx - 1, [])
                            if t.track_id == gt_cur.track_id), None)
            if gt_prev is None:
                continue
            # the tracklets' motion in the previous camera's frame
            T_prev_obj_cur = np.linalg.inv(c2w_prev) @ c2w_cur \
                @ tracklet_pose_cam(gt_cur)
            delta_gt = T_prev_obj_cur @ np.linalg.inv(
                tracklet_pose_cam(gt_prev))
            delta_est = lf.relative_pose_world
            trans_error = float(np.linalg.norm(delta_est[:3, 3]
                                               - delta_gt[:3, 3]))
            R = delta_est[:3, :3] @ delta_gt[:3, :3].T
            rot_error = float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0,
                                                -1.0, 1.0)))
            rec = TrackletEvaluation(frame_idx, track.id, trans_error,
                                     rot_error)
            out.append(rec)
            self.results.append(rec)
            if self.csv is not None:
                self.csv.write(rec)
        return out

    def close(self) -> None:
        if self.csv is not None:
            self.csv.close()
