"""Checkpoint and resume — the port of ``dynslam_tpu/pipeline/
checkpoint.py``, in the same ``.npz`` format and key names, so that a
checkpoint the JAX package saves resumes here and a staged one saved here
loads in the JAX package.

- Staged (``save_checkpoint`` / ``load_checkpoint``): the static map's
  ``TsdfState`` fields, the trajectory and the counters. Object volumes
  and tracks are not saved: resuming restarts object tracking, as the
  reference's ``--frame_offset`` does, and the first resumed frame has no
  VO history.
- Fused (``save_fused_checkpoint`` / ``load_fused_checkpoint``): the JAX
  carry's leaves as ``leaf_<i>`` in ``jax.tree_util`` flattening order,
  which ``convert.FUSED_CARRY_KEYS`` / ``FUSED_DYN_CARRY_KEYS`` name, and
  the port's RANSAC generator state (``rng_state``), so that a static run
  resumed from its checkpoint draws what the continuous run draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dynslam_tpu_torch import convert

FORMAT_VERSION = 1
FUSED_FORMAT_VERSION = 2


def save_checkpoint(path: str, dyn_slam) -> None:
    """Write the static map, the trajectory and the counters."""
    engine = dyn_slam.static_scene
    np.savez_compressed(
        path, version=FORMAT_VERSION,
        **convert.tsdf_state_to_numpy(engine.state),
        pose_history=np.stack(dyn_slam.pose_history),
        current_frame_no=dyn_slam.current_frame_no,
        engine_frame_idx=engine.frame_idx,
        fused_frames=engine.fused_frames)


def load_checkpoint(path: str, dyn_slam) -> int:
    """Restore into a freshly built staged pipeline whose map has the
    checkpoint's pool shape. Returns the frame number to resume from (the
    caller seeks its ``Input`` there)."""
    with np.load(path) as data:
        if int(data["version"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint version "
                             f"{int(data['version'])}, expected "
                             f"{FORMAT_VERSION}")
        engine = dyn_slam.static_scene
        expect = tuple(engine.state.tsdf_w.shape)
        if data["tsdf_w"].shape != expect:
            raise ValueError(f"{path}: pool shape {data['tsdf_w'].shape}, "
                             f"the engine's {expect}")
        engine.state = convert.tsdf_state_from_numpy(
            {k: data[k] for k in convert.STATE_KEYS}, engine.device)
        dyn_slam.pose_history = [np.asarray(p) for p in data["pose_history"]]
        dyn_slam.current_frame_no = int(data["current_frame_no"])
        engine.frame_idx = int(data["engine_frame_idx"])
        engine.fused_frames = int(data["fused_frames"])
    engine.set_pose(dyn_slam.pose_history[-1])
    return dyn_slam.current_frame_no


def _carry_keys(pipeline):
    from dynslam_tpu_torch.pipeline.fused_dynamic import FusedDynamicPipeline

    return convert.FUSED_DYN_CARRY_KEYS \
        if isinstance(pipeline, FusedDynamicPipeline) \
        else convert.FUSED_CARRY_KEYS


def save_fused_checkpoint(path: str, pipeline, pose_history=None,
                          frame: Optional[int] = None) -> None:
    """Write a fused pipeline's carry and host counters (the dynamic
    pipeline's tracker is not saved, as in the JAX package). The CLI
    passes what the pipeline does not know: ``pose_history``
    (world-to-camera poses, entry k + 1 frame k's, as the dynamic pipeline
    keeps them; the static pipeline keeps none) and ``frame``, the next
    frame of the sequence (the dynamic pipeline's ``current_frame_no``
    also counts ``finalize``'s fusion-only replays)."""
    if pipeline.carry is None:
        raise ValueError("save_fused_checkpoint: nothing to save yet")
    keys = _carry_keys(pipeline)
    to_np = convert.fused_dyn_carry_to_numpy \
        if keys is convert.FUSED_DYN_CARRY_KEYS \
        else convert.fused_carry_to_numpy
    arrays = to_np(pipeline.carry)
    leaves = {f"leaf_{i}": np.asarray(arrays[k]) for i, k in enumerate(keys)}
    np.savez_compressed(
        path, version=FUSED_FORMAT_VERSION, n_leaves=len(keys),
        frames=int(getattr(pipeline, "_frames", 0)),
        current_frame_no=int(frame if frame is not None
                             else getattr(pipeline, "current_frame_no", 0)),
        pose_history=np.stack(
            pose_history if pose_history is not None
            else getattr(pipeline, "pose_history",
                         [np.eye(4, dtype=np.float32)])),
        # the RANSAC generator's state (the port's own key: the JAX
        # package draws from the frame index and ignores it)
        rng_state=pipeline.generator.get_state().numpy(),
        **leaves)


def load_fused_checkpoint(path: str, pipeline) -> int:
    """Restore a carry saved by either package's ``save_fused_checkpoint``
    into a freshly built pipeline of the same configuration. Returns the
    frame number to resume from: the dynamic pipeline's
    ``current_frame_no`` or, for the static pipeline, which keeps no frame
    number, the frames it processed. (The JAX package returns the saved
    ``current_frame_no``, 0 for a static checkpoint, and its CLI then
    reads the sequence again from frame 0 onto the restored map.)"""
    keys = _carry_keys(pipeline)
    with np.load(path) as data:
        if int(data["version"]) != FUSED_FORMAT_VERSION:
            raise ValueError(f"{path}: fused checkpoint version "
                             f"{int(data['version'])}, expected "
                             f"{FUSED_FORMAT_VERSION}")
        if int(data["n_leaves"]) != len(keys):
            raise ValueError(f"{path}: {int(data['n_leaves'])} carry leaves, "
                             f"the pipeline's carry has {len(keys)}")
        arrays = {k: data[f"leaf_{i}"] for i, k in enumerate(keys)}
        frames = int(data["frames"])
        current = int(data["current_frame_no"])
        poses = [np.asarray(p) for p in data["pose_history"]]
        rng = data["rng_state"] if "rng_state" in data else None
    dynamic = keys is convert.FUSED_DYN_CARRY_KEYS
    carry = (convert.fused_dyn_carry_from_numpy if dynamic
             else convert.fused_carry_from_numpy)(arrays, pipeline.device)
    pools = [(carry.state.tsdf_w, pipeline.cfg)]
    if dynamic:
        pools.append((carry.inst.tsdf_w[0], pipeline.icfg))
    for words, cfg in pools:
        if tuple(words.shape) != (cfg.pool_capacity, 512):
            raise ValueError(f"{path}: a pool of {tuple(words.shape)} words, "
                             f"the pipeline's {(cfg.pool_capacity, 512)}")
    pipeline.carry = carry
    if rng is not None:
        import torch

        pipeline.generator.set_state(torch.from_numpy(rng))
    if hasattr(pipeline, "_frames"):
        pipeline._frames = frames
    if hasattr(pipeline, "pose_history"):
        pipeline.pose_history = poses
    if hasattr(pipeline, "current_frame_no"):
        pipeline.current_frame_no = current
        return current
    return frames


def fused_pose_history(path: str) -> np.ndarray:
    """The world-to-camera poses a fused checkpoint holds (entry k + 1
    frame k's); a static checkpoint the JAX package saved holds the
    identity alone."""
    with np.load(path) as data:
        return data["pose_history"]

