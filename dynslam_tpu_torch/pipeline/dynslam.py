"""DynSlam — the staged per-frame pipeline (``DynSlam::ProcessFrame``,
src/DynSLAM/DynSlam.{h,cpp}), the port of ``dynslam_tpu/pipeline/
dynslam.py``.

Per frame (DynSlam.cpp:18-175):
  1. read the stereo pair and depth from the ``Input``;
  2. semantic segmentation (dynamic mode);
  3. sparse scene flow and visual odometry, or ICP against the map render
     (``external_odometry`` False, or a failed VO), or ground-truth poses;
     the pose chain new_pose = delta @ pose_history[-1] on the host;
  4. the map's view;
  5. the objects: cut out of the view and fused into their own volumes;
  6. static fusion (K1), the render from the new pose (K2) and decay,
     every ``fusion_every`` frames;
  7. the evaluation and the memory telemetry.

The images go to the device once a frame; the poses stay on the host,
so the staged path syncs by design (the VO delta, the flow, the ICP
verdict, the previews, the counters).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from dynslam_tpu_torch.config import DynSlamConfig
from dynslam_tpu_torch.device import upload
from dynslam_tpu_torch.ops import depth as depth_ops
from dynslam_tpu_torch.pipeline.mapping import MapEngine, PreviewType
from dynslam_tpu_torch.utils.timers import Timers
from dynslam_tpu_torch.viz.meshing import save_engine_mesh


class DynSlam:
    def __init__(self, config: DynSlamConfig, static_scene: MapEngine,
                 segmentation_provider=None, sparse_sf_provider=None,
                 instance_reconstructor=None, evaluation=None,
                 ground_truth_poses: Optional[np.ndarray] = None):
        self.config = config
        self.static_scene = static_scene
        self.device = static_scene.device
        self.segmentation_provider = segmentation_provider
        self.sparse_sf_provider = sparse_sf_provider
        self.instance_reconstructor = instance_reconstructor
        self.evaluation = evaluation
        #: (N, 4, 4) cam-to-world ground-truth poses: when set, the
        #: egomotion comes from here instead of VO (the reference's
        #: groundTruthPoseFpath mode; scene flow still runs for objects)
        self.ground_truth_poses = ground_truth_poses
        #: world-to-camera poses, one per frame processed; frame k's is
        #: pose_history[k + 1] (index 0 = the identity prior, DynSlam.h:213)
        self.pose_history: List[np.ndarray] = [np.eye(4, dtype=np.float32)]
        self.current_frame_no = 0
        self._timers = Timers()
        self._last_seg = None
        self._last_delta = np.eye(4, dtype=np.float32)
        self.last_egomotion = np.eye(4, dtype=np.float32)

    def _gray(self, rgb: torch.Tensor) -> torch.Tensor:
        return depth_ops.rgb_to_gray(rgb).to(torch.float32)

    # ------------------------------------------------------------------
    def process_frame(self, input_) -> bool:
        """One frame; False when the sequence is exhausted."""
        if not input_.has_more_images():
            return False
        t = self._timers
        t.tic("0-total-frame")
        t.tic("1-read-input")
        input_.read_next_frame()
        rgb, depth_mm = input_.get_images()
        t.toc("1-read-input")

        first_frame = self.current_frame_no == 0
        fuse_this_frame = self.current_frame_no % self.config.fusion_every == 0
        rgb_dev = upload(rgb, self.device)

        seg_result = None
        if self.config.dynamic_mode and self.segmentation_provider is not None \
                and fuse_this_frame:
            t.tic("2-segmentation")
            seg_result = self.segmentation_provider.segment_frame(rgb)
            self._last_seg = seg_result
            t.toc("2-segmentation")

        t.tic("3-scene-flow-vo")
        sf = self.sparse_sf_provider
        if sf is not None:
            right_dev = upload(input_.get_stereo_color()[1], self.device)
            sf.compute_sparse_sf(self._gray(rgb_dev), self._gray(right_dev))
            if not sf.flow_available() and not first_frame:
                print("Warning: could not compute scene flow.")
            delta = sf.get_latest_motion()
        else:
            delta = np.eye(4)
        if self.ground_truth_poses is not None:
            k = min(self.current_frame_no, len(self.ground_truth_poses) - 1)
            gt_w2c = np.linalg.inv(self.ground_truth_poses[k])
            delta = gt_w2c @ np.linalg.inv(self.pose_history[-1])
        # ICP against the map render (the engine's trackingController->
        # Track, InfiniTamDriver.h:120-124): the odometry when
        # external_odometry is False (seeded at constant velocity), the
        # fallback when the sparse VO fails
        vo_failed = sf is not None and not first_frame \
            and not sf.motion_available()
        want_icp = (not self.config.external_odometry) or vo_failed
        if (want_icp and self.current_frame_no >= 2
                and self.static_scene._last_raycast is not None
                and self.ground_truth_poses is None):
            seed = self._last_delta if not self.config.external_odometry \
                else delta
            res = self.static_scene.track_icp(
                depth_mm.astype(np.float32) / 1000.0,
                init_world_to_cam=seed @ self.pose_history[-1])
            if bool(res.success):
                delta = res.world_to_cam.cpu().numpy() @ np.linalg.inv(
                    self.pose_history[-1])
        self._last_delta = np.asarray(delta, np.float32)
        # the reference's GetLastEgomotion is old_c2w^-1 @ new_c2w, the
        # INVERSE of the VO delta (InfiniTamDriver.h:126,133)
        self.last_egomotion = np.linalg.inv(delta).astype(np.float32)
        new_pose = (delta @ self.pose_history[-1]).astype(np.float32)
        self.static_scene.set_pose(new_pose)
        self.pose_history.append(new_pose)
        t.toc("3-scene-flow-vo")

        t.tic("4-update-view")
        self.static_scene.update_view(
            rgb_dev, depth_mm, bilateral=self.config.use_bilateral_filter)
        t.toc("4-update-view")

        if (self.config.dynamic_mode and self.instance_reconstructor is not None
                and seg_result is not None and sf is not None
                and sf.flow_available()):
            t.tic("5-instances")
            self.instance_reconstructor.process_frame(
                self, self.static_scene, seg_result, sf.get_flow(), sf)
            t.toc("5-instances")

        if not first_frame and fuse_this_frame:
            t.tic("6-static-fusion")
            self.static_scene.integrate()
            t.toc("6-static-fusion")
            t.tic("7-raycast-prepare")
            self.static_scene.prepare_next_step()
            t.toc("7-raycast-prepare")
            t.tic("8-decay")
            self.static_scene.decay()
            t.toc("8-decay")
        else:
            # keep the engine's frame counter aligned with the frames
            self.static_scene.frame_idx += 1

        if self.evaluation is not None:
            t.tic("9-evaluation")
            self.evaluation.evaluate_frame(input_, self)
            self.evaluation.log_memory_use(self)
            if self.instance_reconstructor is not None:
                tr = self.instance_reconstructor.tracker
                self.evaluation.log_tracker(
                    self.current_frame_no, len(tr.active_tracks),
                    sum(1 for x in tr.active_tracks.values()
                        if x.has_reconstruction()),
                    0)  # the staged path processes every detection
            t.toc("9-evaluation")

        self.current_frame_no += 1
        t.toc("0-total-frame")
        return True

    # ------------------------------------------------------------------
    # accessors (DynSlam.h:76-268)
    def get_pose_history(self) -> List[np.ndarray]:
        return self.pose_history

    def get_last_egomotion(self) -> np.ndarray:
        """The camera delta's inverse of the latest frame
        (DynSlam::GetLastEgomotion)."""
        return self.last_egomotion

    def get_current_pose(self) -> np.ndarray:
        return self.pose_history[-1]

    def get_static_map_raycast_preview(
            self, cam_to_world: Optional[np.ndarray] = None,
            preview: PreviewType = PreviewType.COLOR,
            compositing: bool = True) -> np.ndarray:
        """A preview of the static map, (H, W, 3) uint8, with the objects
        composited in."""
        img = self.static_scene.get_image(preview, cam_to_world)
        if compositing and self.instance_reconstructor is not None:
            img = self.instance_reconstructor.composite_instances(
                img, preview, cam_to_world, self)
        return img

    def get_static_map_raycast_depth_preview(
            self, cam_to_world: Optional[np.ndarray] = None,
            compositing: bool = True) -> torch.Tensor:
        """The depth render the evaluation reads (DynSlam.h:124-132), on
        the device, with the objects z-merged in."""
        d = self.static_scene.get_float_image(cam_to_world)
        if compositing and self.instance_reconstructor is not None:
            d = self.instance_reconstructor.composite_instance_depth_maps(
                d, cam_to_world, self)
        return d

    def get_latest_seg_result(self):
        return self._last_seg

    def get_timing_report(self) -> str:
        return self._timers.report()

    def last_frame_ms(self) -> float:
        return self._timers.latest_ms("0-total-frame")

    def save_static_map(self, out_path: str) -> int:
        """Mesh the static map to an OBJ file (SaveStaticMap,
        DynSlam.cpp:189); returns the triangle count."""
        return save_engine_mesh(self.static_scene, out_path)

    def save_dynamic_object(self, track_id: int, out_path: str) -> None:
        """Mesh one object (SaveDynamicObject, DynSlam.cpp:199)."""
        if self.instance_reconstructor is None:
            raise ValueError("save_dynamic_object: no instance reconstructor")
        self.instance_reconstructor.save_object_to_mesh(track_id, out_path)

    def finalize(self) -> None:
        """End of the sequence: the static map's decay catch-up."""
        self.static_scene.decay_catchup()
