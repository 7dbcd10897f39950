"""LIDAR ground-truth depth evaluation — the port of
``dynslam_tpu/eval/evaluation.py`` (the reference's ``Evaluation``,
src/DynSLAM/Evaluation/Evaluation.{h,cpp}), computed in plain PyTorch on
the pipeline's device.

Per frame (EvaluateFrameSeparate, Evaluation.cpp:85-147): every Velodyne
point is projected into the left and right colour cameras (depth clamp
[min, max]) to a ground-truth disparity; the rendered (fused) and the
input depth at its pixel become disparities b f / z; each point is
classified {missing, error, correct} for every delta_max of the sweep and
the KITTI-2015 rule (an error iff delta > 3 px and > 5% of the GT
disparity), on the intersection of both sources' valid pixels; the
instance masks and track states route each point to the static or the
dynamic-reconstructed bucket (SegmentedCallback.cpp:12-63).

The lookup is the JAX package's: rendered and input depth go to whole
millimetres (round half to even), clipped to 15 bits, and are packed with
the 2-bit association code into one int32 image that each point gathers
once. Counts equal the JAX package's on the same inputs
(``tests/test_torch_eval.py``) but for one repair: the JAX package
unpacks the rendered depth with an arithmetic shift, so a rendered depth
of 16.384 m or more (bit 31 of the packed word) reads back negative and
counts as an error; here the 15 bits are masked out, as the input depth's
are.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from dynslam_tpu_torch.device import (
    DeviceLike, constant, resolve_device, upload,
)
from dynslam_tpu_torch.eval.csv_writer import CsvWriter
from dynslam_tpu_torch.eval.records import (
    DepthEvaluation, DepthFrameEvaluation, DepthResult, MemoryUsageEntry,
    TrackerFrameEntry, base_csv_name,
)
from dynslam_tpu_torch.io.velodyne import VelodyneIO

#: association codes of the segmented evaluation
ASSOC_STATIC = 0
ASSOC_DYNAMIC = 1
ASSOC_SKIP = 2

#: points of a scan evaluated at most (KITTI scans hold ~120k)
MAX_LIDAR_POINTS = 1 << 17


def _rows_times(x4: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x4 @ m.T`` for (N, 4) rows and an (R, 4) matrix, in the order
    XLA's CPU backend evaluates the JAX package's small matmuls: the four
    products rounded, then summed pairwise, (p0 + p1) + (p2 + p3)."""
    p = x4[:, None, :] * m[None]
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def evaluate_depth(
    lidar: torch.Tensor,  # (M, 3) f32 xyz, velodyne frame
    velo_to_cam: torch.Tensor,  # (4, 4) f32
    proj: torch.Tensor,  # (6, 4) f32: the left then the right (3, 4)
    rendered_depth_m: torch.Tensor,  # (H, W) f32, 0 = missing
    input_depth_m: torch.Tensor,  # (H, W) f32, 0 = missing
    assoc_map: torch.Tensor,  # (H, W) int8 association codes
    consts: torch.Tensor,  # (3,) f32: baseline * focal, min, max depth
    delta_maxes: tuple,
    kitti_style: tuple,
    compare_on_intersection: bool = True,
):
    """(counts, gt_stats): counts (n_delta, 3 buckets (unified, static,
    dynamic), 2 sources (fused, input), 4 fields (error, missing, correct,
    missing_separate)) int64, and the GT-quality stats (epipolar
    violations, negative disparities, evaluated points) int64 (3,)."""
    dev = lidar.device
    h, w = rendered_depth_m.shape
    bf, min_depth, max_depth = consts[0], consts[1], consts[2]
    velo_h = torch.cat([lidar, torch.ones_like(lidar[:, :1])], 1)
    cam = _rows_times(velo_h, velo_to_cam)
    z = cam[:, 2]
    in_range = (z >= min_depth) & (z <= max_depth)
    pp = _rows_times(cam, proj)  # (M, 6): left then right
    ul = pp[:, 0] / pp[:, 2]
    vl = pp[:, 1] / pp[:, 2]
    ur = pp[:, 3] / pp[:, 5]
    vr = pp[:, 4] / pp[:, 5]
    # whole pixels kept as floats: equal to the JAX package's int32 tests
    # for every point in range, and free of float -> int overflow
    col, row = torch.round(ul), torch.round(vl)
    in_img = (col >= 0) & (col < w) & (row >= 0) & (row < h)
    lidar_disp = ul - ur
    seen = in_range & in_img
    ok = seen & (lidar_disp >= 0.0)
    # GT quality (Evaluation.cpp:262-275): row disagreements beyond 1.2 px
    # between the two projections are epipolar violations; negative GT
    # disparities make the reference throw, here they are counted and
    # dropped
    epi = seen & (row != torch.round(vr)) & ((vl - vr).abs() > 1.2)
    gt_stats = torch.stack([epi, seen & (lidar_disp < 0.0), ok]).sum(-1)

    # one packed lookup: rendered mm (15 bits) | input mm (15) | assoc (2)
    rend_mm = torch.clamp(torch.round(rendered_depth_m * 1000.0), 0,
                          32767).to(torch.int32)
    inp_mm = torch.clamp(torch.round(input_depth_m * 1000.0), 0,
                         32767).to(torch.int32)
    packed = (rend_mm << 17) | (inp_mm << 2) | assoc_map.to(torch.int32)
    colc = torch.clamp(col, 0, w - 1).to(torch.int64)
    rowc = torch.clamp(row, 0, h - 1).to(torch.int64)
    at = packed.reshape(-1)[rowc * w + colc]
    depth = torch.stack([(at >> 17) & 0x7FFF, (at >> 2) & 0x7FFF]) \
        .to(torch.float32) * 1e-3  # (2, M): fused, input
    assoc = at & 3

    missing = depth == 0.0
    disp = bf / torch.where(missing, torch.inf, depth)
    delta = (disp - lidar_disp).abs()  # (2, M)
    if compare_on_intersection:
        miss = (missing[0] | missing[1]).expand(2, -1)
    else:
        miss = missing
    dmax = constant(delta_maxes, torch.float32, dev)[:, None, None]
    kitti = constant(kitti_style, torch.bool, dev)[:, None, None]
    err = (delta[None] > dmax) \
        & (~kitti | (delta[None] > 0.05 * lidar_disp)) & ~miss[None]
    buckets = torch.stack([ok & (assoc != ASSOC_SKIP),
                           ok & (assoc == ASSOC_STATIC),
                           ok & (assoc == ASSOC_DYNAMIC)])  # (3, M)
    n_err = (buckets[None, :, None] & err[:, None]).sum(-1)  # (D, 3, 2)
    flags = torch.cat([miss, ~miss, missing])  # (6, M)
    per = (buckets[:, None] & flags[None]).sum(-1)  # (3, 6)
    n_d = len(delta_maxes)
    mis = per[:, 0:2].expand(n_d, 3, 2)
    valid = per[:, 2:4].expand(n_d, 3, 2)
    sep = per[:, 4:6].expand(n_d, 3, 2)
    counts = torch.stack([n_err, mis, valid - n_err, sep], -1)
    return counts, gt_stats


def evaluate_depth_packed(lidar, velo_to_cam, proj, rendered_depth_m,
                          input_depth_m, assoc_map, consts, used_blocks,
                          decayed_blocks, delta_maxes: tuple,
                          kitti_style: tuple,
                          compare_on_intersection: bool = True
                          ) -> torch.Tensor:
    """``evaluate_depth`` and the memory telemetry in one flat float32
    vector, fetched in one copy: counts.ravel() ++ gt_stats ++
    [used_blocks, decayed_blocks] (each a 0-d tensor or a host number)."""
    counts, gt_stats = evaluate_depth(
        lidar, velo_to_cam, proj, rendered_depth_m, input_depth_m,
        assoc_map, consts, delta_maxes, kitti_style,
        compare_on_intersection=compare_on_intersection)
    dev = lidar.device
    mem = [v.to(device=dev, dtype=torch.float32).reshape(1)
           if torch.is_tensor(v)
           else upload(np.asarray([v], np.float32), dev)
           for v in (used_blocks, decayed_blocks)]
    return torch.cat([counts.reshape(-1).to(torch.float32),
                      gt_stats.to(torch.float32), *mem])


def build_association_map(
    height: int, width: int, seg_result, tracker,
    det_states: Optional[Dict[int, object]] = None,
) -> np.ndarray:
    """The segmented evaluation's routing, rasterized on the host
    (SegmentedCallback): inside a copy mask, a car/bus with a track that
    is not Uncertain -> DYNAMIC, other possibly-dynamic classes -> SKIP;
    everything else STATIC. ``det_states`` supplies {id(detection):
    TrackState} directly (the fused dynamic pipeline evaluates a frame
    whose tracks may already hold a newer detection)."""
    from dynslam_tpu_torch.instances.track import TrackState

    assoc = np.zeros((height, width), np.int8)
    if seg_result is None:
        return assoc
    det_to_state: Dict[int, object] = det_states if det_states is not None \
        else {}
    if tracker is not None and det_states is None:
        for track in tracker.active_tracks.values():
            det_to_state[id(track.last_frame.detection)] = track.state
    for det in seg_result.instance_detections:
        m = det.copy_mask.to_full_frame(height, width)
        if not det.is_possibly_dynamic():
            continue  # stays static
        if det.is_reconstructable():
            state = det_to_state.get(id(det))
            if state is not None and state != TrackState.UNCERTAIN:
                assoc[m] = ASSOC_DYNAMIC
            else:
                assoc[m] = ASSOC_SKIP
        else:
            assoc[m] = ASSOC_SKIP
    return assoc


class Evaluation:
    """Per-frame evaluation and CSV logging (the reference's L6 harness):
    the five CSV files under ``base_csv_name``'s config-encoding names.
    The staged pipeline calls ``evaluate_frame`` and ``log_memory_use``
    each frame; the fused pipelines go through ``FusedEvaluation``."""

    def __init__(self, dataset_root: str, input_config, input_, calib,
                 config, csv_out_dir: str = "csv",
                 device: DeviceLike = None):
        self.config = config
        self.params = config.evaluation
        self.calib = calib
        self.device = resolve_device(device)
        self.velodyne = VelodyneIO(
            os.path.join(dataset_root, input_config.velodyne_folder),
            input_config.velodyne_fname_format or "%06d.bin")
        self.baseline_m = config.calibration.baseline_m
        self.focal_px = float(calib.proj_left_color[0, 0])
        base = base_csv_name(
            max_decay_weight=config.decay.max_decay_weight,
            dataset_id=input_.get_dataset_identifier(),
            frame_offset=input_.frame_offset,
            depth_provider_name=(input_.depth_provider.get_name()
                                 if input_.depth_provider else "none"),
            voxel_size_meters=config.scene.voxel_size_m,
            max_depth_meters=config.max_depth_m,
            is_dynamic=config.dynamic_mode,
            # the real flag, as the reference encodes it (the JAX package
            # writes False; its fused path rejects the flag)
            direct_refinement=config.use_direct_refinement,
            use_depth_weighting=config.map.use_depth_weighting,
            fusion_every=config.fusion_every,
            base_folder=csv_out_dir,
        )
        self.csv_unified = CsvWriter(base + "-unified-depth-result.csv")
        self.csv_static = CsvWriter(base + "-static-depth-result.csv")
        self.csv_dynamic = CsvWriter(base + "-dynamic-depth-result.csv")
        self.csv_memory = CsvWriter(base + "-memory.csv")
        self.csv_tracker = CsvWriter(base + "-tracker.csv")
        self._delta_maxes = tuple(float(d) for d in self.params.delta_maxes)
        self._kitti_flags = tuple([False] * len(self._delta_maxes)) + (
            (True,) if self.params.kitti_style else ())
        self._all_deltas = self._delta_maxes + (
            (3.0,) if self.params.kitti_style else ())
        self.last_frame_results: Optional[Dict[str, DepthFrameEvaluation]] \
            = None
        # the projection constants on the device, uploaded once
        dev = self.device
        self._velo_to_cam = upload(
            np.asarray(calib.velo_to_left_cam, np.float32), dev)
        self._proj = upload(np.concatenate(
            [calib.proj_left_color, calib.proj_right_color]).astype(
                np.float32), dev)
        self._consts = upload(np.asarray(
            [np.float32(self.baseline_m * self.focal_px),
             config.min_depth_m, config.max_depth_m], np.float32), dev)

    def evaluate_frame(self, input_, dyn_slam) -> None:
        """EvaluateFrame (Evaluation.cpp:34-147) of the staged pipeline:
        the frame ``evaluation_delay`` frames back (0 = the current one),
        rendered (objects composited in) at that frame's pose, against its
        input depth — re-read from the sequence for a past frame — and
        routed with the LATEST segmentation and tracks, as the reference
        does (GetLatestSeg, Evaluation.cpp:111-127)."""
        if not self.params.enabled:
            return
        delay = self.params.evaluation_delay
        eval_frame = dyn_slam.current_frame_no - delay
        if eval_frame < 0:
            return
        input_frame_idx = input_.frame_offset + eval_frame
        if not self.velodyne.frame_available(input_frame_idx):
            return  # frames without LIDAR are skipped (Evaluation.cpp:54-59)
        lidar = self.velodyne.read_frame(input_frame_idx)
        # the evaluated frame's pose is pose_history[k + 1] (index 0 is the
        # identity prior, Evaluation.cpp:93)
        cam_to_world = np.linalg.inv(dyn_slam.pose_history[eval_frame + 1])
        rendered = dyn_slam.get_static_map_raycast_depth_preview(
            cam_to_world=cam_to_world, compositing=True)
        if delay == 0:
            _, input_depth_mm = input_.get_images()
        else:
            _, input_depth_mm = input_.get_frame_images(input_frame_idx)
        rec = dyn_slam.instance_reconstructor
        assoc = build_association_map(
            self.config.frame_height, self.config.frame_width,
            dyn_slam.get_latest_seg_result(),
            rec.tracker if rec is not None else None)
        counts = self.evaluate_depth(
            lidar, rendered, input_depth_mm.astype(np.float32) / 1000.0,
            assoc)
        self.write_frame_rows(eval_frame, input_.get_dataset_identifier(),
                              counts)

    def log_memory_use(self, dyn_slam) -> None:
        """The per-frame memory row (Evaluation.h:234-243)."""
        scene = dyn_slam.static_scene
        self.csv_memory.write(MemoryUsageEntry(
            dyn_slam.current_frame_no, scene.get_used_memory_bytes(),
            scene.get_saved_decay_memory_bytes(), self.config.decay))

    def write_frame_rows(self, eval_frame: int, dataset_id: str,
                         counts: np.ndarray
                         ) -> Dict[str, DepthFrameEvaluation]:
        """One frame's count tensor as typed records and CSV rows (the
        tail of EvaluateFrameSeparate)."""
        results = {}
        for bi, name in enumerate(("unified", "static", "dynamic")):
            evals: List[DepthEvaluation] = []
            for di, dmax in enumerate(self._all_deltas):
                c = counts[di, bi]
                fused = DepthResult(
                    int(c[0, 0] + c[0, 1] + c[0, 2]), int(c[0, 0]),
                    int(c[0, 1]), int(c[0, 2]), int(c[0, 3]))
                inp = DepthResult(
                    int(c[1, 0] + c[1, 1] + c[1, 2]), int(c[1, 0]),
                    int(c[1, 1]), int(c[1, 2]), int(c[1, 3]))
                evals.append(DepthEvaluation(dmax, fused, inp,
                                             self._kitti_flags[di]))
            results[name] = DepthFrameEvaluation(
                eval_frame, dataset_id, self.config.max_depth_m, evals)
        self.csv_unified.write(results["unified"])
        if self.params.semantic_evaluation:
            self.csv_static.write(results["static"])
            self.csv_dynamic.write(results["dynamic"])
        self.last_frame_results = results
        return results

    def warn_gt_stats(self, epi: int, neg: int, n_ok: int) -> None:
        """GT-quality warnings (Evaluation.cpp:300-303; the reference
        aborts on a negative disparity, here it is dropped and warned)."""
        self.last_epi_errors = epi
        self.last_negative_disp = neg
        if epi > 5:
            print(f"WARNING: Found {epi} possible epipolar violations in the "
                  f"ground truth, out of {n_ok} valid LIDAR points.",
                  file=sys.stderr)
        if neg > 0:
            print(f"WARNING: {neg} negative-disparity ground-truth points "
                  "dropped (the reference aborts here).", file=sys.stderr)

    def _on_device(self, x, np_dtype) -> torch.Tensor:
        """A host array (as ``np_dtype``) or a tensor on the device."""
        if not torch.is_tensor(x):
            return upload(np.asarray(x, np_dtype), self.device)
        if x.device.type != self.device.type:
            raise ValueError(f"evaluation: a map on {x.device}, the "
                             f"evaluation on {self.device}")
        return x

    def _lidar(self, lidar: np.ndarray) -> torch.Tensor:
        """The scan's first MAX_LIDAR_POINTS points (x, y, z) on the
        device, uploaded at their own length."""
        n = min(len(lidar), MAX_LIDAR_POINTS)
        return upload(np.ascontiguousarray(lidar[:n, :3], np.float32),
                      self.device)

    def evaluate_depth(self, lidar: np.ndarray, rendered_depth_m,
                       input_depth_m, assoc) -> np.ndarray:
        """Counts (n_delta, 3, 2, 4) of one frame, synchronously."""
        counts, gt_stats = evaluate_depth(
            self._lidar(lidar), self._velo_to_cam, self._proj,
            self._on_device(rendered_depth_m, np.float32),
            self._on_device(input_depth_m, np.float32),
            self._on_device(assoc, np.int8), self._consts,
            self._all_deltas, self._kitti_flags)
        epi, neg, n_ok = (int(x) for x in gt_stats.cpu())
        self.warn_gt_stats(epi, neg, n_ok)
        return counts.cpu().numpy()

    def log_tracker(self, frame_id: int, active: int, reconstructed: int,
                    dropped_cum: int, oversize_cum: int = 0,
                    truncated_px_cum: int = 0) -> None:
        """Per-frame tracker telemetry row (a file of its own; the
        reference's schemas are untouched)."""
        self.csv_tracker.write(TrackerFrameEntry(
            frame_id, active, reconstructed, dropped_cum, oversize_cum,
            truncated_px_cum))

    def close(self) -> None:
        for wtr in (self.csv_unified, self.csv_static, self.csv_dynamic,
                    self.csv_memory, self.csv_tracker):
            wtr.close()
