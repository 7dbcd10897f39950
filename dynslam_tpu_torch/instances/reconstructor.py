"""InstanceReconstructor — the staged path's dynamic-object engine, the
port of ``dynslam_tpu/instances/reconstructor.py``
(``src/DynSLAM/InstRecLib/InstanceReconstructor.{h,cpp}``).

Per frame (ProcessFrame, InstanceReconstructor.cpp:172-207):
  1. an instance view for every possibly-dynamic detection, with its
     masked scene flow (flow inside the delete mask whose previous
     position lies in the copy bbox, :802-849);
  2. association to tracks (``InstanceTracker``);
  3. per track: motion estimate and state machine, then the silhouette:
     Uncertain and dynamic objects are cut out of the main view (on the
     device, ``ops/masks.py``); reconstructable ones (car, bus) keep their
     cut view (:226-285);
  4. reconstructions: a new pooled volume (or a standalone ``MapEngine``
     when the pool is full), fusion of the newest view at the chained
     relative pose, the reap of stale volumes (:315-401, :569-700); the
     pool's staged fusions run in flushes, one per step of the longest
     catch-up chain (one flush on most frames).

Compositing z-merges each renderable track's render into the static one
(:851-990). With ``use_direct_refinement`` each fused view's object
motion is first refined by dense photometric alignment against the
track's previous view (``ops/direct_align.py``; the reference ships this
disabled).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from dynslam_tpu_torch.config import DynSlamConfig
from dynslam_tpu_torch.device import DeviceLike, resolve_device, upload
from dynslam_tpu_torch.instances.track import Track, TrackFrame, TrackState
from dynslam_tpu_torch.instances.tracker import InstanceTracker
from dynslam_tpu_torch.instances.volume_pool import InstanceVolumePool
from dynslam_tpu_torch.io.segmentation import InstanceSegmentationResult
from dynslam_tpu_torch.ops import direct_align
from dynslam_tpu_torch.ops import masks as mask_ops
from dynslam_tpu_torch.ops.tsdf import recip32
from dynslam_tpu_torch.pipeline.mapping import (
    MapEngine, PreviewType, instance_config_from,
)
from dynslam_tpu_torch.utils import se3
from dynslam_tpu_torch.viz.meshing import save_engine_mesh

#: matplotlib tab10 palette for track tints
#: (InstanceReconstructor kMatplotlib2Palette)
PALETTE = np.array(
    [
        [0x1F, 0x77, 0xB4], [0xFF, 0x7F, 0x0E], [0x2C, 0xA0, 0x2C],
        [0xD6, 0x27, 0x28], [0x94, 0x67, 0xBD], [0x8C, 0x56, 0x4B],
        [0xE3, 0x77, 0xC2], [0x7F, 0x7F, 0x7F], [0xBC, 0xBD, 0x22],
        [0x17, 0xBE, 0xCF],
    ],
    dtype=np.float32,
)


class InstanceReconstructor:
    def __init__(self, config: DynSlamConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.tracker = InstanceTracker(config.tracker)
        self.frame_idx = 0
        #: object motions direct refinement replaced (only with
        #: ``use_direct_refinement``)
        self.direct_refinements = 0
        self._instance_cfg = instance_config_from(config)
        self.volume_pool = InstanceVolumePool(
            self._instance_cfg, config.decay,
            capacity=config.instance_map.max_objects, device=self.device)

    # ------------------------------------------------------------------
    def _extract_scene_flow(self, detection, matches: np.ndarray,
                            check_sf_start: bool = True) -> np.ndarray:
        """Masked flow: the current position inside the delete mask and,
        optionally, the previous one inside the copy bbox (ExtractSceneFlow,
        InstanceReconstructor.cpp:802-849)."""
        if len(matches) == 0:
            return np.zeros((0, 8), np.float32)
        h, w = self.config.frame_height, self.config.frame_width
        full = detection.delete_mask.to_full_frame(h, w)
        u = np.clip(matches[:, 0].astype(int), 0, w - 1)
        v = np.clip(matches[:, 1].astype(int), 0, h - 1)
        sel = full[v, u]
        if check_sf_start:
            bb = detection.copy_mask.bbox
            up = matches[:, 4].astype(int)
            vp = matches[:, 5].astype(int)
            sel &= (up >= bb.x0) & (up <= bb.x1) & (vp >= bb.y0) \
                & (vp <= bb.y1)
        return matches[sel]

    # ------------------------------------------------------------------
    def process_frame(self, dyn_slam, static_engine: MapEngine,
                      seg_result: InstanceSegmentationResult,
                      scene_flow, sf_provider) -> None:
        self.frame_idx = dyn_slam.current_frame_no
        matches = scene_flow.matches

        new_frames: List[TrackFrame] = []
        camera_pose = dyn_slam.get_current_pose()
        for det in seg_result.instance_detections:
            if not det.is_possibly_dynamic():
                continue
            new_frames.append(TrackFrame(
                frame_idx=self.frame_idx, detection=det,
                masked_flow=self._extract_scene_flow(det, matches),
                camera_pose=np.asarray(camera_pose)))
        self.tracker.process_instance_views(self.frame_idx, new_frames)

        egomotion = dyn_slam.get_last_egomotion()
        rgb = static_engine._view_rgb
        depth = static_engine._view_depth_m
        for track in list(self.tracker.active_tracks.values()):
            if track.end_time != self.frame_idx:
                continue
            track.update(egomotion, sf_provider)
            rgb, depth = self._process_silhouette(track, rgb, depth)
        static_engine.set_view_device(rgb, depth)
        self._process_reconstructions()

    def _process_silhouette(self, track: Track, rgb, depth):
        """Cut or remove the newest detection from the main view
        (ProcessSilhouette, InstanceReconstructor.cpp:226-285)."""
        det = track.last_frame.detection
        h, w = self.config.frame_height, self.config.frame_width
        possibly_dynamic = det.is_possibly_dynamic()
        masks = [det.delete_mask.to_full_frame(h, w)]
        cut = (track.state == TrackState.DYNAMIC
               or self.config.always_reconstruct_objects) \
            and track.state != TrackState.UNCERTAIN \
            and det.is_reconstructable()
        if cut:
            masks.append(det.copy_mask.to_full_frame(h, w))
        dev = upload(np.stack(masks), self.device)
        delete_mask = dev[0]
        if track.state == TrackState.UNCERTAIN:
            if possibly_dynamic:
                rgb, depth = mask_ops.remove_silhouette(rgb, depth,
                                                        delete_mask)
        elif cut:
            inst_rgb, inst_depth, rgb, depth = mask_ops.cut_out_instance(
                rgb, depth, dev[1], delete_mask)
            track.last_frame.instance_rgb = inst_rgb
            track.last_frame.instance_depth_m = inst_depth
        elif (track.state == TrackState.DYNAMIC
              or self.config.always_reconstruct_objects) and possibly_dynamic:
            # e.g. a pedestrian: removed, not reconstructed
            rgb, depth = mask_ops.remove_silhouette(rgb, depth, delete_mask)
        # STATIC (and not always_reconstruct_objects): left in the view
        return rgb, depth

    # ------------------------------------------------------------------
    def _process_reconstructions(self) -> None:
        """InitializeReconstruction / FuseFrame / the reap gate
        (ProcessReconstructions, InstanceReconstructor.cpp:315-361). Each
        volume's views are fused in order; across volumes they go in
        rounds, so the pool stages one view a volume a flush and a frame
        takes as many flushes as its longest catch-up chain."""
        chains = []
        for track in self.tracker.active_tracks.values():
            if not track.last_frame.detection.is_reconstructable():
                continue
            if track.end_time != self.frame_idx:
                gap = self.frame_idx - track.end_time
                if track.needs_cleanup and track.has_reconstruction() \
                        and gap >= 2:
                    track.reap_reconstruction()
                    track.needs_cleanup = False
                continue
            if not track.has_reconstruction():
                eligible = track.eligible_for_reconstruction() and (
                    track.state == TrackState.DYNAMIC
                    or (track.state == TrackState.STATIC
                        and self.config.always_reconstruct_objects))
                if eligible:
                    chains.append((track,
                                   self._initialize_reconstruction(track)))
            else:
                chains.append((track, [len(track.frames) - 1]))
        for r in range(max((len(c) for _, c in chains), default=0)):
            for track, frames in chains:
                if r < len(frames):
                    self._fuse_frame(track, frames[r])
        self.volume_pool.flush()

    def _initialize_reconstruction(self, track: Track) -> List[int]:
        """A new pooled volume (InstanceReconstructor.cpp:363-401; a
        standalone engine when the pool is full); returns the frames of
        its catch-up fusion, every fusable one."""
        track.reconstruction = self.volume_pool.acquire_volume() or MapEngine(
            self._instance_cfg, self.config.decay, device=self.device)
        first = track.get_first_fusable_frame_index()
        return list(range(first, len(track.frames))) if first > -1 else []

    def _gray(self, rgb) -> torch.Tensor:
        """An instance view's channel mean (XLA's order: the sum times the
        float32 reciprocal of 3)."""
        return torch.as_tensor(rgb).to(self.device, torch.float32).sum(-1) \
            * recip32(3.0)

    def _direct_refine_motion(self, track: Track, frame_idx: int) -> None:
        """Refine the frame's object motion (T_cur<-prev) by dense
        photometric alignment of the track's previous instance view to this
        one, before fusion reads the pose chain (the reference's disabled
        Direct/ call sites, InstanceReconstructor.cpp:460-566). A pair that
        aligns no pixel or gives a non-finite pose keeps the sparse
        estimate."""
        frame = track.frames[frame_idx]
        if frame_idx < 1 or frame.relative_pose is None:
            return
        prev = track.frames[frame_idx - 1]
        if prev.instance_rgb is None or frame.instance_rgb is None:
            return
        res = direct_align.refine_pose(
            self._gray(prev.instance_rgb), prev.instance_depth_m,
            self._gray(frame.instance_rgb),
            self.config.intrinsics.as_tuple(), T_init=frame.relative_pose,
            device=self.device)
        T = res.T.cpu()
        if not torch.isfinite(T).all() or float(res.valid_fraction) <= 0.0:
            return
        frame.relative_pose = T.numpy()
        frame.relative_pose_tr = se3.log_se3(T).numpy()
        self.direct_refinements += 1

    def _fuse_frame(self, track: Track, frame_idx: int) -> None:
        """Fuse one track frame at its chained relative pose (FuseFrame,
        InstanceReconstructor.cpp:569-700)."""
        if track.state == TrackState.UNCERTAIN:
            return
        frame = track.frames[frame_idx]
        if frame.instance_rgb is None:
            return
        if self.config.use_direct_refinement:
            self._direct_refine_motion(track, frame_idx)
        rel_pose = track.get_frame_pose(frame_idx)
        if rel_pose is None:
            return
        engine = track.reconstruction
        engine.set_view_device(frame.instance_rgb, frame.instance_depth_m)
        engine.set_pose(rel_pose.astype(np.float32))
        engine.integrate()
        if self.config.decay.enabled:
            engine.decay()
        track.needs_cleanup = True
        track.count_fused_frame()
        # the previous frame's view is not needed any more (the reference
        # discards it after fusion too, InstanceReconstructor.cpp:688-694)
        if frame_idx >= 1:
            track.frames[frame_idx - 1].instance_rgb = None
            track.frames[frame_idx - 1].instance_depth_m = None

    # ------------------------------------------------------------------
    # compositing (InstanceReconstructor.cpp:851-990)
    @staticmethod
    def _instance_render_pose(track: Track, view_w2c: np.ndarray):
        """The volume-frame cam_to_world that renders the track's volume
        from a camera at world-to-cam ``view_w2c``: p_view = view_w2c @
        C2W_k @ chain_k @ p_vol."""
        k = len(track.frames) - 1
        chain = track.get_frame_pose(k)
        if chain is None:
            return None
        vol_w2c = view_w2c @ np.linalg.inv(track.frames[k].camera_pose) \
            @ chain
        return np.linalg.inv(vol_w2c)

    def _active_renderable_tracks(self):
        return [t for t in self.tracker.active_tracks.values()
                if t.has_reconstruction() and t.end_time == self.frame_idx]

    def _batched_track_raycasts(self, view_w2c: np.ndarray):
        """(tracks with their render poses, the pool's stacked renders of
        them) — or (tracks, None) when a track's volume is a standalone
        engine, which the caller renders by itself."""
        tracks, slots, poses = [], [], []
        for track in self._active_renderable_tracks():
            pose = self._instance_render_pose(track, view_w2c)
            if pose is None:
                continue
            tracks.append((track, pose))
            handle = track.reconstruction
            if getattr(handle, "pool", None) is self.volume_pool:
                slots.append(handle.slot)
                poses.append(pose)
        if not tracks:
            return [], None
        if len(slots) == len(tracks):
            return tracks, self.volume_pool.raycast_many(slots, poses)
        return tracks, None

    def _view_w2c(self, cam_to_world, dyn_slam) -> np.ndarray:
        return np.linalg.inv(cam_to_world) if cam_to_world is not None \
            else dyn_slam.get_current_pose()

    def composite_instance_depth_maps(self, depth: torch.Tensor,
                                      cam_to_world: Optional[np.ndarray],
                                      dyn_slam) -> torch.Tensor:
        """Z-merge the object renders into a static depth render
        (CompositeInstanceDepthMaps, :911-931); on the device."""
        tracks, rc_b = self._batched_track_raycasts(
            self._view_w2c(cam_to_world, dyn_slam))
        if not tracks:
            return depth
        if rc_b is not None:
            return mask_ops.composite_depth_many(depth, rc_b.depth)
        out = depth
        for track, pose in tracks:
            out = mask_ops.composite_depth(
                out, track.reconstruction.get_raycast(pose).depth)
        return out

    def composite_instances(self, color: np.ndarray, preview: PreviewType,
                            cam_to_world: Optional[np.ndarray],
                            dyn_slam) -> np.ndarray:
        """Composite the object renders into a static colour preview with
        per-track tints (CompositeInstances, :933-990)."""
        tracks, rc_b = self._batched_track_raycasts(
            self._view_w2c(cam_to_world, dyn_slam))
        if not tracks:
            return color
        static_depth = dyn_slam.static_scene.get_raycast(cam_to_world).depth
        out_color = upload(np.asarray(color, np.uint8), self.device)
        tints = upload(np.stack([PALETTE[t.id % len(PALETTE)]
                                 for t, _ in tracks]), self.device)
        if rc_b is not None:
            out_color, _ = mask_ops.composite_color_many(
                out_color, static_depth, rc_b.color, rc_b.depth, tints)
            return out_color.cpu().numpy()
        for i, (track, pose) in enumerate(tracks):
            rc = track.reconstruction.get_raycast(pose)
            out_color, static_depth = mask_ops.composite_color(
                out_color, static_depth, rc.color, rc.depth, tints[i])
        return out_color.cpu().numpy()

    # -- previews (GetInstancePreviewRGB/Depth, :287-313) -----------------
    def get_instance_preview_rgb(self, track_id: int):
        track = self.tracker.tracks.get(track_id)
        if track is None or track.last_frame.instance_rgb is None:
            return None
        return track.last_frame.instance_rgb.cpu().numpy()

    def get_instance_preview_depth(self, track_id: int):
        track = self.tracker.tracks.get(track_id)
        if track is None or track.last_frame.instance_depth_m is None:
            return None
        return track.last_frame.instance_depth_m.cpu().numpy()

    def save_object_to_mesh(self, track_id: int, path: str) -> int:
        """Mesh one object volume to an OBJ file (SaveObjectToMesh,
        InstanceReconstructor.cpp:736-763); returns the triangle count."""
        track = self.tracker.tracks.get(track_id)
        if track is None or not track.has_reconstruction():
            raise ValueError(f"track {track_id} has no reconstruction")
        return save_engine_mesh(track.reconstruction, path)
