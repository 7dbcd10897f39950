"""Pooled per-object volumes — the port of
``dynslam_tpu/instances/volume_pool.py``: every object volume of the staged
path lives in one stacked pool (``tsdf.create_pool``) instead of one
engine per track (the reference's ``new InfiniTamDriver`` per object,
InstanceReconstructor.cpp:363-401).

``flush`` runs the fusions staged during a frame in three steps: per
staged slot, allocation and the visible list at that slot's pose (a host
loop); ONE K1 launch over exactly the staged volumes
(``integrate_many``, K1's volume axis), each with its full-frame masked
view, the frame's intrinsics and its own frame index; per slot, decay at
its pre-increment frame index. The JAX package pads the batch to a power
of two for its compile cache; the padded rows are inactive and come back
unchanged, so the port leaves them out.

``raycast`` and ``raycast_many`` run K2 once per slot at the object
configuration (the JAX package's unrolled slot loop). A slot's render,
reap or block count runs the staged fusions only when that slot has one
(the JAX package runs them whenever any slot has one; the slots are
independent, so the maps are the same). Poses are host
numpy; each site inverts them as the JAX package does
(``jnp.linalg.inv`` here, not the rigid inverse of ``MapEngine``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dynslam_tpu_torch.config import VoxelDecayParams
from dynslam_tpu_torch.device import DeviceLike, constant, resolve_device, upload
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.ops.integrate import integrate_many
from dynslam_tpu_torch.ops.raycast import Raycast, raycast
from dynslam_tpu_torch.pipeline.mapping import lu_inverse_np


class InstanceVolumePool:
    """A fixed-capacity pool of object volumes with batched fusion."""

    def __init__(self, cfg: tsdf.TsdfConfig, decay_params: VoxelDecayParams,
                 capacity: int, device: DeviceLike = None):
        self.cfg = cfg
        self.decay_params = decay_params
        self.capacity = capacity
        self.device = resolve_device(device)
        self._fresh = tsdf.create_state(cfg, self.device)
        self.states = tsdf.create_pool(cfg, capacity, self.device)
        self._free: List[int] = list(range(capacity))
        #: per-slot fused-frame counter (the decay clock, like
        #: MapEngine.frame_idx)
        self.frame_idx = np.zeros(capacity, np.int64)
        self._staged: Dict[int, tuple] = {}
        self.intrinsics_vec = constant((cfg.fx, cfg.fy, cfg.cx, cfg.cy),
                                       torch.float32, self.device)

    # -- lifecycle -------------------------------------------------------
    def acquire_volume(self) -> Optional["PooledVolume"]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._reset_slot(slot)
        return PooledVolume(self, slot)

    def release(self, slot: int) -> None:
        self._staged.pop(slot, None)
        if slot not in self._free:
            self._free.append(slot)

    def _reset_slot(self, slot: int) -> None:
        tsdf.assign_state(tsdf.pool_slot(self.states, slot), self._fresh)
        self.frame_idx[slot] = 0

    def slot_state(self, slot: int) -> tsdf.TsdfState:
        """Slot ``slot`` as a ``TsdfState`` of views into the pool."""
        return tsdf.pool_slot(self.states, slot)

    # -- batched fusion ---------------------------------------------------
    def stage_fuse(self, slot: int, rgb: torch.Tensor, depth_m: torch.Tensor,
                   world_to_cam) -> None:
        """Queue one fusion; flushes first if the slot already has one
        staged (catch-up fusion chains are sequential per volume)."""
        if slot in self._staged:
            self.flush()
        self._staged[slot] = (rgb, depth_m, world_to_cam)

    def flush(self) -> None:
        """Run the staged fusions: per-slot allocation and visibility, one
        K1 launch over the staged volumes, per-slot decay."""
        if not self._staged:
            return
        cfg = self.cfg
        ids = list(self._staged)
        n = len(ids)
        w2c_np = np.stack([np.asarray(self._staged[s][2], np.float32)
                           for s in ids])
        poses = upload(np.concatenate([w2c_np, lu_inverse_np(w2c_np)]),
                       self.device)
        w2c, c2w = poses[:n], poses[n:]
        fidx = [int(self.frame_idx[s]) for s in ids]
        vis_slots, vis_masks = [], []
        for i, s in enumerate(ids):
            st = self.slot_state(s)
            depth = self._staged[s][1]
            origin = tsdf.compute_origin(cfg, c2w[i])
            grid = tsdf.build_local_grid(cfg, st, origin)
            st, grid, _ = tsdf.allocate(cfg, st, grid, origin, depth, c2w[i],
                                        fidx[i])
            sl, m = tsdf.visible_blocks(cfg, st, grid, origin, w2c[i])
            vis_slots.append(sl)
            vis_masks.append(m)
        integrate_many(
            cfg, self.states, ids, torch.stack(vis_slots),
            torch.stack(vis_masks),
            torch.stack([self._staged[s][0] for s in ids]),
            torch.stack([self._staged[s][1] for s in ids]), w2c, fidx,
            self.intrinsics_vec.expand(n, 4))
        dp = self.decay_params
        for i, s in enumerate(ids):
            # no block of a volume is older than its frame index
            if dp.enabled and fidx[i] >= int(dp.min_decay_age):
                tsdf.decay(cfg, self.slot_state(s), fidx[i],
                           float(dp.max_decay_weight), int(dp.min_decay_age))
            self.frame_idx[s] += 1
        self._staged.clear()

    def _flush_for(self, slot: int) -> None:
        """Run the staged fusions if ``slot`` has one: a slot's render,
        reap or count needs its own fusions done, not the others'."""
        if slot in self._staged:
            self.flush()

    # -- renders ----------------------------------------------------------
    def raycast(self, slot: int, cam_to_world) -> Raycast:
        """K2 on one slot at the object configuration, from a host 4x4."""
        self._flush_for(slot)
        c2w_np = np.asarray(cam_to_world, np.float32)
        poses = upload(np.stack([c2w_np, lu_inverse_np(c2w_np)]), self.device)
        state = self.slot_state(slot)
        origin = tsdf.compute_origin(self.cfg, poses[0])
        grid = tsdf.build_local_grid(self.cfg, state, origin)
        slots, mask = tsdf.visible_blocks(self.cfg, state, grid, origin,
                                          poses[1])
        return raycast(self.cfg, state, grid, origin, slots, mask, poses[0],
                       self.intrinsics_vec)

    def raycast_many(self, slot_ids: Sequence[int],
                     cam_to_worlds: Sequence[np.ndarray]) -> Raycast:
        """Several slots' renders, one K2 pass each, stacked on a leading
        axis in ``slot_ids`` order."""
        if not slot_ids:
            raise ValueError("raycast_many: no slot")
        rcs = [self.raycast(s, p) for s, p in zip(slot_ids, cam_to_worlds)]
        return Raycast(*(torch.stack(xs) for xs in zip(*rcs)))

    # -- per-slot operations ----------------------------------------------
    def reap(self, slot: int, max_weight: float) -> int:
        self._flush_for(slot)
        _, n = tsdf.decay(self.cfg, self.slot_state(slot),
                          int(self.frame_idx[slot]), float(max_weight), 0,
                          force_all=True)
        return int(n)

    def used_block_count(self, slot: int) -> int:
        self._flush_for(slot)
        return int(tsdf.memory_stats(self.cfg, self.slot_state(slot))[0])


class PooledVolume:
    """``MapEngine``-shaped handle on one pool slot (what
    ``InstanceReconstructor`` and ``Track`` use)."""

    def __init__(self, pool: InstanceVolumePool, slot: int):
        self.pool = pool
        self.slot = slot
        self._view = None
        self._pose_w2c = np.eye(4, dtype=np.float32)
        self.fused_frames = 0

    @property
    def cfg(self) -> tsdf.TsdfConfig:
        return self.pool.cfg

    @property
    def state(self) -> tsdf.TsdfState:
        self.pool._flush_for(self.slot)
        return self.pool.slot_state(self.slot)

    def set_view_device(self, rgb, depth_m) -> None:
        self._view = (rgb, depth_m)

    def set_pose(self, world_to_cam) -> None:
        self._pose_w2c = world_to_cam

    def integrate(self) -> None:
        if self._view is None:
            raise RuntimeError("PooledVolume.integrate: set_view_device first")
        self.pool.stage_fuse(self.slot, self._view[0], self._view[1],
                             self._pose_w2c)
        self.fused_frames += 1

    def decay(self, blocking: bool = False):
        # part of the pool's flush
        return 0

    def get_raycast(self, cam_to_world=None) -> Raycast:
        pose = cam_to_world if cam_to_world is not None \
            else np.linalg.inv(self._pose_w2c)
        return self.pool.raycast(self.slot, pose)

    def reap(self, max_weight: float) -> int:
        return self.pool.reap(self.slot, max_weight)

    def reset(self) -> None:
        self.pool._staged.pop(self.slot, None)
        self.pool._reset_slot(self.slot)
        self.fused_frames = 0

    def release(self) -> None:
        self.pool.release(self.slot)

    def get_used_block_count(self) -> int:
        return self.pool.used_block_count(self.slot)

    def get_used_memory_bytes(self) -> int:
        return int(tsdf.memory_stats(self.cfg, self.state)[1])
