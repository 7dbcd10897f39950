"""InstanceTracker: greedy data association of detections to tracks — a
copy of ``dynslam_tpu/instances/tracker.py``. Mirrors
`src/DynSLAM/InstRecLib/InstanceTracker.{h,cpp}`: best-scoring track above
0.10 wins; leftover detections start new tracks; tracks inactive for > 50
frames are pruned (releasing their volumes). Host-side, like the
reference's CPU tracker.
"""

from __future__ import annotations

from typing import Dict, List

from dynslam_tpu_torch.config import TrackerParams
from dynslam_tpu_torch.instances.track import Track, TrackFrame


class InstanceTracker:
    def __init__(self, params: TrackerParams):
        self.params = params
        self.tracks: Dict[int, Track] = {}
        self._track_count = 0

    @property
    def active_tracks(self) -> Dict[int, Track]:
        return self.tracks

    def find_best_track(self, frame: TrackFrame):
        """(track, score) with the highest match score, or (None, 0)."""
        best, best_score = None, -1.0
        for track in self.tracks.values():
            score = track.score_match(frame)
            if score > best_score:
                best, best_score = track, score
        return best, best_score

    def process_instance_views(
        self, frame_idx: int, new_frames: List[TrackFrame]
    ) -> None:
        """Associate -> create leftovers -> prune
        (InstanceTracker.cpp:11-35)."""
        leftovers = []
        for frame in new_frames:
            track, score = self.find_best_track(frame)
            if track is not None and score > self.params.score_threshold:
                track.add_frame(frame)
            else:
                leftovers.append(frame)

        for frame in leftovers:
            track = Track(self._track_count, self.params)
            self._track_count += 1
            track.add_frame(frame)
            self.tracks[track.id] = track

        self.prune_tracks(frame_idx)

    def prune_tracks(self, current_frame_idx: int) -> None:
        """Drop tracks inactive longer than the threshold, releasing their
        reconstruction volumes (InstanceTracker.cpp:37-59)."""
        dead = [
            tid
            for tid, t in self.tracks.items()
            if current_frame_idx - t.end_time > self.params.inactive_frame_threshold
        ]
        for tid in dead:
            self.tracks[tid].release_reconstruction()
            del self.tracks[tid]
