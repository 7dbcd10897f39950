"""Typed CSV records, byte-compatible with the reference's schema
(Evaluation/Records.h:13-191) so the reference notebooks can be pointed at
our CSV outputs for A/B comparison — a copy of
``dynslam_tpu/eval/records.py`` (headers, rows and file names byte-equal,
``tests/test_torch_eval.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from dynslam_tpu_torch.config import VoxelDecayParams


@dataclass(frozen=True)
class DepthResult:
    """Accuracy accumulator {total, error, missing, correct} for one depth
    source. Ref: Records.h:13-60."""

    measurement_count: int
    error_count: int
    missing_count: int
    correct_count: int
    missing_separate_count: int

    def __post_init__(self):
        if self.measurement_count != (
                self.error_count + self.missing_count + self.correct_count):
            raise ValueError(
                "measurements must partition into error+missing+correct")
        if self.missing_count < self.missing_separate_count:
            raise ValueError("missing_separate_count exceeds missing_count")

    def correct_pixel_ratio(self, include_missing: bool) -> float:
        if include_missing:
            return self.correct_count / self.measurement_count
        denom = self.measurement_count - self.missing_count
        return self.correct_count / denom if denom else 0.0

    def get_header(self) -> str:
        return (
            "measurements_count,error_count,missing_count,correct_count,"
            "missing_separate_count"
        )

    def get_data(self) -> str:
        return "%d,%d,%d,%d,%d" % (
            self.measurement_count,
            self.error_count,
            self.missing_count,
            self.correct_count,
            self.missing_separate_count,
        )


@dataclass(frozen=True)
class DepthEvaluation:
    """Fused-vs-input comparison at one delta_max. Ref: Records.h:71-107."""

    delta_max: float
    fused_result: DepthResult
    input_result: DepthResult
    kitti_style: bool

    def get_header(self) -> str:
        k = "-kitti" if self.kitti_style else ""
        cols = []
        for src in ("fusion", "input"):
            for fieldname in ("total", "error", "missing", "correct", "missing-separate"):
                cols.append(f"{src}-{fieldname}-{self.delta_max:.2f}{k}")
        return ",".join(cols)

    def get_data(self) -> str:
        return f"{self.fused_result.get_data()},{self.input_result.get_data()}"


@dataclass(frozen=True)
class DepthFrameEvaluation:
    """One frame's evaluations across the delta_max sweep.
    Ref: Records.h:110-137."""

    frame_idx: int
    dataset_id: str
    max_depth_meters: float
    evaluations: Sequence[DepthEvaluation]

    def get_header(self) -> str:
        return ",".join(["frame"] + [e.get_header() for e in self.evaluations])

    def get_data(self) -> str:
        return ",".join([str(self.frame_idx)] + [e.get_data() for e in self.evaluations])


@dataclass(frozen=True)
class TrackletEvaluation:
    """Per-pose object-tracking error. Ref: Records.h:140-160."""

    frame_id: int
    track_id: int
    trans_error: float
    rot_error: float

    def get_header(self) -> str:
        return "frame_id,track_id,trans_error,rot_error"

    def get_data(self) -> str:
        return "%d,%d,%f,%f" % (
            self.frame_id,
            self.track_id,
            self.trans_error,
            self.rot_error,
        )


@dataclass(frozen=True)
class TrackerFrameEntry:
    """Per-frame instance-tracker telemetry: active/reconstructed track
    counts + the CUMULATIVE dropped-detection count (detections beyond
    the fused path's K mask slots; always 0 on the staged path, which
    processes every detection like the reference). This is a NEW file —
    the reference's CSV schemas (Records.h) are untouched."""

    frame_id: int
    active_tracks: int
    reconstructed_tracks: int
    dropped_detections_cum: int
    #: cut masks whose bbox exceeded the fusion crop (cumulative; each
    #: either full-frame-fallback fused or truncated)
    oversize_masks_cum: int = 0
    #: copy-mask pixels LOST to crop truncation (cumulative; nonzero only
    #: with oversize_mask_fallback=False)
    truncated_pixels_cum: int = 0

    def get_header(self) -> str:
        return ("frame_id,active_tracks,reconstructed_tracks,"
                "dropped_detections_cum,oversize_masks_cum,"
                "truncated_pixels_cum")

    def get_data(self) -> str:
        return "%d,%d,%d,%d,%d,%d" % (
            self.frame_id, self.active_tracks, self.reconstructed_tracks,
            self.dropped_detections_cum, self.oversize_masks_cum,
            self.truncated_pixels_cum,
        )


@dataclass(frozen=True)
class MemoryUsageEntry:
    """Static-map memory telemetry. Ref: Records.h:163-191."""

    frame_id: int
    memory_usage_bytes: int
    saved_memory_cum_bytes: int
    decay_params: VoxelDecayParams

    def get_header(self) -> str:
        return (
            "frame_id,memory_usage_bytes,saved_memory_cum_bytes,"
            "decay_enabled,decay_min_age,decay_max_weight"
        )

    def get_data(self) -> str:
        return "%d,%d,%d,%d,%d,%d" % (
            self.frame_id,
            self.memory_usage_bytes,
            self.saved_memory_cum_bytes,
            int(self.decay_params.enabled),
            self.decay_params.min_decay_age,
            self.decay_params.max_decay_weight,
        )


def base_csv_name(
    max_decay_weight: int,
    dataset_id: str,
    frame_offset: int,
    depth_provider_name: str,
    voxel_size_meters: float,
    max_depth_meters: float,
    is_dynamic: bool,
    direct_refinement: bool,
    use_depth_weighting: bool,
    fusion_every: int = 1,
    base_folder: str = "csv",
) -> str:
    """Config-encoding CSV base name. Ref: Evaluation.h:56-80."""
    name = (
        f"{base_folder}/k-{max_decay_weight}-{dataset_id}-offset-{frame_offset}"
        f"-depth-{depth_provider_name}-voxelsize-{voxel_size_meters:.4f}"
        f"-max-depth-m-{max_depth_meters:.2f}"
        f"-{'dynamic-mode' if is_dynamic else 'NO-dynamic'}"
        f"-{'with-direct-ref' if direct_refinement else 'NO-direct-ref'}"
        f"-{'with-fusion-weights' if use_depth_weighting else 'NO-fusion-weights'}"
    )
    if fusion_every != 1:
        name += f"-fuse-every-{fusion_every}"
    return name


def depth_csv_name(**kw) -> str:
    return base_csv_name(**kw) + "-unified-depth-result.csv"


def static_depth_csv_name(**kw) -> str:
    return base_csv_name(**kw) + "-static-depth-result.csv"


def dynamic_depth_csv_name(**kw) -> str:
    return base_csv_name(**kw) + "-dynamic-depth-result.csv"


def tracking_csv_name(**kw) -> str:
    return base_csv_name(**kw) + "-3d-tracking-result.csv"


def memory_csv_name(**kw) -> str:
    return base_csv_name(**kw) + "-memory.csv"
