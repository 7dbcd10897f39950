"""Edge cases of the port's dynamic slice, after tests/test_fused_dynamic.py:
the full-frame fallback for masks larger than the fusion crop (against
the JAX package, frame by frame), masks that overlap, a mask on the
bottom-right edge of a frame whose size is not a multiple of 4, and the
uint16 / uint32 bit-plane tiers with many detections."""

import dataclasses

import jax
import numpy as np
import pytest

from dynslam_tpu_torch.config import InstanceMapParams
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic

from test_torch_fused_dynamic import check_step, run_pair
from torch_frontend_inputs import (
    dynamic_slice_config, jax_dynamic_sampler, make_dynamic_frames,
)
from torch_threads import threads

torch_threads = threads(2)


def _run_port(cfg, frames):
    pipe = build_fused_dynamic(cfg, cfg.calibration, device="cpu")
    pipe.sampler = jax_dynamic_sampler(jax.random.PRNGKey(0), pipe.K,
                                       cfg.vo.ransac_iters,
                                       cfg.tracker.object_ransac_iters)
    for lg, rg, rgb, objid in frames:
        pipe.process_frame(lg, rg, rgb, tseg.detections_from_instance_ids(
            objid, min_size_px=8, score=0.98))
    pipe.finalize()
    return pipe


def _slot_blocks(pipe):
    (t,) = [t for t in pipe.tracker.active_tracks.values()
            if t.has_reconstruction()]
    return t.reconstruction.get_used_block_count()


def test_oversize_mask_fullframe_fallback():
    """A car mask larger than a (24, 32) crop takes the full-frame fallback
    — held to the JAX package after every frame — and loses no voxel
    against a crop that covers the frame; with the fallback off the loss
    is counted."""
    frames = make_dynamic_frames(dynamic_slice_config())
    cfg = dynamic_slice_config(fusion_crop=(24, 32))
    jp, fb = run_pair(cfg, frames, check=check_step)
    assert fb.oversize_masks == jp.oversize_masks > 0
    assert fb.truncated_pixels == 0

    full = _run_port(dynamic_slice_config(fusion_crop=(120, 160)), frames)
    assert full.oversize_masks == 0 and full.truncated_pixels == 0
    n_full = _slot_blocks(full)
    assert n_full > 100
    assert _slot_blocks(fb) == n_full

    tr = _run_port(dynamic_slice_config(fusion_crop=(24, 32),
                                        oversize_mask_fallback=False), frames)
    assert tr.oversize_masks > 0 and tr.truncated_pixels > 0
    assert _slot_blocks(tr) < n_full


def _small_config(wt, ht, **imp):
    base = dict(blocks_per_object=512, local_dims=(32, 16, 48),
                max_new_blocks_per_frame=256)
    base.update(imp)
    return dataclasses.replace(dynamic_slice_config(), frame_width=wt,
                               frame_height=ht,
                               instance_map=InstanceMapParams(**base))


def test_overlapping_masks_cut_exclusively():
    """Two overlapping car masks: the earlier slot's delete mask takes the
    overlap (the reference's sequential cut), so no pixel lands in two
    object views."""
    wt, ht = 256, 96
    oa = np.zeros((ht, wt), np.int16)
    oa[30:60, 60:110] = 1
    ob = np.zeros((ht, wt), np.int16)
    ob[30:60, 98:150] = 2  # overlaps A in columns 98..109
    det_a = tseg.detections_from_instance_ids(oa, min_size_px=8)[0]
    det_b = tseg.detections_from_instance_ids(ob, min_size_px=8)[0]
    cfg = _small_config(wt, ht, max_objects=2, max_detections=4)
    pipe = build_fused_dynamic(cfg, cfg.calibration, device="cpu")
    assert (pipe.crop_h, pipe.crop_w) == (ht, wt)

    rng = np.random.default_rng(1)
    lg = rng.uniform(0, 255, (ht, wt)).astype(np.float32)
    rgb = np.full((ht, wt, 3), 200, np.uint8)
    pipe.process_frame(lg, lg, rgb, [])
    pipe.process_frame(lg, lg, rgb, [det_a, det_b])  # speculative cuts
    assert (pipe.carry.pending_org == 0).all()
    pr = pipe.carry.pending_rgb.numpy()
    in_a, in_b = pr[0, :, :, 0] > 0, pr[1, :, :, 0] > 0
    cm_a = det_a.copy_mask.to_full_frame(ht, wt)
    cm_b = det_b.copy_mask.to_full_frame(ht, wt)
    dm_a = det_a.delete_mask.to_full_frame(ht, wt)
    overlap = cm_b & dm_a
    assert overlap.sum() > 50
    assert (in_a == cm_a).all()
    assert not in_b[overlap].any()
    assert in_b[cm_b & ~dm_a].all()
    assert not (in_a & in_b).any()


def test_unaligned_frame_edge_mask_covered_by_crop():
    """A mask on the bottom-right edge of a 158x117 frame fits a 4-aligned
    crop of the padded 160x120 frame: no oversize fallback, and the crop
    origin is the padded clamp (64, 56)."""
    wt, ht = 158, 117
    objid = np.zeros((ht, wt), np.int16)
    objid[90:117, 120:158] = 1
    dets = tseg.detections_from_instance_ids(objid, min_size_px=8)
    bb = dets[0].copy_mask.bbox
    assert bb.y1 == ht - 1 and bb.x1 == wt - 1
    cfg = _small_config(wt, ht, max_objects=2, max_detections=4,
                        fusion_crop=(64, 96))
    pipe = build_fused_dynamic(cfg, cfg.calibration, device="cpu")
    assert not pipe.mask_exceeds_crop(dets[0], ht, wt)
    rng = np.random.default_rng(3)
    lg = rng.uniform(0, 255, (ht, wt)).astype(np.float32)
    rgb = np.full((ht, wt, 3), 200, np.uint8)
    pipe.process_frame(lg, lg, rgb, [])
    pipe.process_frame(lg, lg, rgb, dets)
    assert int(pipe._dispatch_meta[5]["trunc_px"].sum()) == 0
    assert pipe.carry.pending_org[0].tolist() == [64, 56]
    # the crop holds the whole mask: its pixels, shifted by the origin
    cm = dets[0].copy_mask.to_full_frame(ht, wt)
    in_crop = pipe.carry.pending_rgb[0, :, :, 0].numpy() > 0
    assert in_crop.sum() == cm.sum()
    assert in_crop[90 - 56: 117 - 56, 120 - 64: 158 - 64].all()


@pytest.mark.parametrize("k,n,dtype", [(16, 10, np.uint16),
                                       (20, 20, np.uint32)])
def test_many_detections_tracked(k, n, dtype):
    """K mask slots past 8 (uint16 planes) and past 16 (uint32 planes,
    slots up to 19): every detection is tracked and cut, none dropped;
    past K the largest are kept and the rest counted."""
    wt, ht = 320, 96
    objid = np.zeros((ht, wt), np.int16)
    for i in range(n):
        x0 = 2 + i * 15
        objid[10 + (i % 2) * 44: 32 + (i % 2) * 44, x0: x0 + 12] = i + 1
    dets = tseg.detections_from_instance_ids(objid, min_size_px=4)
    assert len(dets) == n
    cfg = _small_config(wt, ht, max_objects=4, max_detections=k)
    pipe = build_fused_dynamic(cfg, cfg.calibration, device="cpu")
    assert pipe.K == k and pipe.S == 4
    db, _ = pipe.pack_mask_bits(dets, ht, wt, pipe.K)
    assert db.dtype == dtype
    rng = np.random.default_rng(2)
    lg = rng.uniform(0, 255, (ht, wt)).astype(np.float32)
    rgb = np.full((ht, wt, 3), 200, np.uint8)
    pipe.process_frame(lg, lg, rgb, [])
    pipe.process_frame(lg, lg, rgb, dets)
    assert len(pipe.tracker.active_tracks) == n
    assert pipe._dropped_detections == 0
    # the first and the highest slot cut exactly their copy masks (the
    # crop covers the frame)
    assert (pipe.carry.pending_org == 0).all()
    for j in (0, n - 1):
        cm = dets[j].copy_mask.to_full_frame(ht, wt)
        assert np.array_equal(pipe.carry.pending_rgb[j, :, :, 0].numpy() > 0,
                              cm), j
    pipe.process_frame(lg, lg, rgb, dets + dets[:6])  # 6 over K at most
    assert pipe._dropped_detections == max(0, n + 6 - k)
    pipe.finalize()
    assert np.isfinite(pipe.get_pose()).all()
