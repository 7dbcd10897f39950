"""Sparse scene flow and visual odometry of the staged path — the port of
``dynslam_tpu/pipeline/sparse_sf.py`` (the reference's ``SparseSFProvider``
contract, SparseSFProvider.h:61-78, backed by libviso2 there and by
``ops/features.py`` and ``ops/egomotion.py`` here).

Stateful like ``VisoSparseSFProvider``: ``compute_sparse_sf`` takes the
current stereo pair, matches it against the previous one (the first
``refine_cap`` valid matches, in index order, get the LK refinement; the
rest are dropped), and estimates the camera motion; on a failed estimate
it holds the last successful one, selected on the device.
``extract_motion`` runs the estimator again on an object's masked flow,
with the camera's RANSAC hypotheses and the object IRLS/GN depths.

RANSAC draws come from a ``torch.Generator`` unless ``sampler`` is given:
``sampler(index, valid)`` returns (ransac_iters, 3) draws, ``index`` being
the frame counter for the camera and ``10_000_019 +`` the counter for
objects — the JAX package's ``fold_in`` keys, which the parity tests feed
through it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dynslam_tpu_torch.config import StereoCalibration, VisualOdometryParams
from dynslam_tpu_torch.device import DeviceLike, resolve_device, upload
from dynslam_tpu_torch.ops import egomotion as ego_ops
from dynslam_tpu_torch.ops import features as feat_ops
from dynslam_tpu_torch.pipeline.fused import Sampler, _refine_matches

#: offset of the object estimates' RANSAC key from the frame counter
OBJECT_KEY_OFFSET = 10_000_019


class SparseSceneFlow:
    """RawFlow rows (N, 8) and their validity, host numpy."""

    def __init__(self, flow: np.ndarray, valid: np.ndarray):
        self.flow = flow
        self.valid = valid

    @property
    def matches(self) -> np.ndarray:
        """The valid rows, (M, 8)."""
        return self.flow[self.valid]


class SparseSFProvider:
    def __init__(self, intrinsics_vec, calib: StereoCalibration,
                 params: Optional[VisualOdometryParams] = None,
                 seed: int = 0, device: DeviceLike = None,
                 sampler: Optional[Sampler] = None):
        fx, cu, cv = intrinsics_vec
        self.params = params or VisualOdometryParams()
        self.device = resolve_device(device)
        self.calib_vec = upload(np.asarray([fx, cu, cv, calib.baseline_m],
                                           np.float32), self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sampler = sampler
        self._prev = None  # (features left, right, gray left, right)
        self._latest_flow_dev = None
        self._latest_flow: Optional[SparseSceneFlow] = None
        self._latest_est: Optional[ego_ops.MotionEstimate] = None
        self._held_motion: Optional[torch.Tensor] = None
        self._frame_counter = 0

    def _draws(self, index: int, valid: torch.Tensor):
        return None if self.sampler is None else self.sampler(index, valid)

    # -- SparseSFProvider API (SparseSFProvider.h:61-78) -----------------
    def compute_sparse_sf(self, left_gray, right_gray) -> None:
        """Process the current stereo pair: (H, W) gray, numpy or tensors
        (copied to the device as float32)."""
        lg = torch.as_tensor(left_gray).to(self.device, torch.float32)
        rg = torch.as_tensor(right_gray).to(self.device, torch.float32)
        cur_l, cur_r = feat_ops.detect_features_pair(lg, rg, self.params)
        if self._prev is not None:
            prev_l, prev_r, prev_lg, prev_rg = self._prev
            flow, valid = feat_ops.circular_match(cur_l, cur_r, prev_l,
                                                  prev_r, self.params)
            flow, valid = _refine_matches(lg, rg, prev_lg, prev_rg, flow,
                                          valid, self.params)
            est = ego_ops.estimate_motion(
                flow, valid, self.calib_vec,
                torch.zeros(6, device=self.device), self.params,
                generator=self.generator,
                sample_ids=self._draws(self._frame_counter, valid))
            # on a failed estimate HOLD the last successful motion
            # (libviso2's getMotion keeps returning the last Tr_delta)
            held = self._held_motion if self._held_motion is not None \
                else torch.eye(4, device=self.device)
            self._held_motion = torch.where(est.success, est.matrix, held)
            self._latest_flow_dev = (flow, valid)
            self._latest_flow = None
            self._latest_est = est
        self._prev = (cur_l, cur_r, lg, rg)
        self._frame_counter += 1

    def flow_available(self) -> bool:
        return self._latest_flow_dev is not None

    def get_flow(self) -> SparseSceneFlow:
        """Host copy of the latest flow (syncs once a frame)."""
        if self._latest_flow is None:
            flow, valid = self._latest_flow_dev
            self._latest_flow = SparseSceneFlow(flow.cpu().numpy(),
                                                valid.cpu().numpy())
        return self._latest_flow

    def get_latest_motion(self) -> np.ndarray:
        """4x4 T_cur<-prev, float32; the last successful estimate when the
        current frame failed (libviso2 getMotion semantics). Syncs."""
        if self._held_motion is None:
            return np.eye(4)
        return self._held_motion.cpu().numpy()

    def get_latest_motion_device(self) -> torch.Tensor:
        if self._held_motion is None:
            return torch.eye(4, device=self.device)
        return self._held_motion

    def motion_available(self) -> bool:
        """Whether the latest estimate succeeded (syncs)."""
        return self._latest_est is not None and bool(self._latest_est.success)

    def extract_motion(self, masked_flow: np.ndarray, initial_estimate=None,
                       irls_rounds: Optional[int] = None,
                       gn_iters: Optional[int] = None
                       ) -> Optional[np.ndarray]:
        """A 6-dof twist (viso2 form) of a masked flow subset (an object's
        motion), or None on failure — ``ExtractMotion`` returning an empty
        vector (VisoSparseSFProvider.cpp:70-82). ``irls_rounds`` and
        ``gn_iters`` override the camera estimator's refinement depth; the
        RANSAC hypotheses stay the camera's. Syncs."""
        n = len(masked_flow)
        if n < 6:
            return None
        params = self.params
        overrides = {}
        if irls_rounds is not None and irls_rounds != params.irls_rounds:
            overrides["irls_rounds"] = irls_rounds
        if gn_iters is not None and gn_iters != params.gn_iters:
            overrides["gn_iters"] = gn_iters
        if overrides:
            params = dataclasses.replace(params, **overrides)
        N = params.max_matches
        take = min(n, N)
        packed = np.zeros((N, 8 + 1), np.float32)
        packed[:take, :8] = masked_flow[:take]
        packed[:take, 8] = 1.0
        init = np.zeros(6, np.float32) if initial_estimate is None \
            else np.asarray(initial_estimate, np.float32)
        dev = upload(np.concatenate([packed.reshape(-1), init]), self.device)
        flow = dev[:N * 9].view(N, 9)[:, :8]
        valid = dev[:N * 9].view(N, 9)[:, 8] > 0
        est = ego_ops.estimate_motion(
            flow, valid, self.calib_vec, dev[N * 9:], params,
            generator=self.generator,
            sample_ids=self._draws(OBJECT_KEY_OFFSET + self._frame_counter,
                                   valid))
        if not bool(est.success):
            return None
        return est.tr.cpu().numpy()
