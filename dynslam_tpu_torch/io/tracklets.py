"""KITTI tracking-benchmark labels ("tracklets") — the port of
``dynslam_tpu/io/tracklets.py`` (Evaluation/Tracklets.{h,cpp}): one record
a line (frame, track id, type, truncation, occlusion, alpha, 2-D box,
3-D size and location, rotation about y), grouped by frame.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

TRACK_TYPES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting",
               "Cyclist", "Tram", "Misc", "DontCare")

OCCLUSION_LEVELS = {
    -1: "Not applicable",
    0: "Fully visible",
    1: "Partly occluded",
    2: "Largely occluded",
    3: "Unknown occlusion",
}


@dataclass(frozen=True)
class TrackletFrame:
    frame: int
    track_id: int
    type: str
    truncated: int
    occlusion_level: int
    #: observation angle [-pi, pi]
    alpha: float
    #: (left, top, right, bottom) zero-based pixel coords
    bbox_2d: tuple
    #: (height, width, length) metres
    dimensions_m: np.ndarray
    #: camera-frame location, metres
    location_cam_m: np.ndarray
    #: rotation around the camera's y (up) axis [-pi, pi]
    rotation_y: float


def read_tracklets(path: str, cars_only: bool = True) -> List[TrackletFrame]:
    out: List[TrackletFrame] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ttype = parts[2]
            if ttype not in TRACK_TYPES:
                raise ValueError(f"unknown track type {ttype!r} in {path!r}")
            if cars_only and ttype != "Car":
                continue
            out.append(TrackletFrame(
                frame=int(parts[0]),
                track_id=int(parts[1]),
                type=ttype,
                truncated=int(float(parts[3])),
                occlusion_level=int(parts[4]),
                alpha=float(parts[5]),
                bbox_2d=tuple(float(x) for x in parts[6:10]),
                dimensions_m=np.array([float(x) for x in parts[10:13]]),
                location_cam_m=np.array([float(x) for x in parts[13:16]]),
                rotation_y=float(parts[16])))
    return out


def read_grouped_tracklets(path: str, cars_only: bool = True
                           ) -> Dict[int, List[TrackletFrame]]:
    """Tracklets grouped by frame index (Tracklets.h:96)."""
    grouped: Dict[int, List[TrackletFrame]] = defaultdict(list)
    for t in read_tracklets(path, cars_only):
        grouped[t.frame].append(t)
    return dict(grouped)
