"""The dynamic slice end to end: the port's ``FusedDynamicPipeline`` (CPU,
plain versions of the kernels) against the JAX package's
(``use_pallas=False``) on the tests/test_fused_dynamic.py scene (160x120,
6 frames, one car), at the default fusion crop (which clamps to the
whole frame here) and at a (64, 96) crop, whose shifted principal points
the instance fusion then takes. Each side makes its own detections from
the same object ids; the port runs with JAX's RANSAC draws."""

import jax
import numpy as np
import pytest
import torch

from dynslam_tpu.io import segmentation as jseg
from dynslam_tpu.pipeline.fused_dynamic import (
    FusedDynamicPipeline as JaxDynPipeline,
)
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic
from dynslam_tpu_torch.pipeline.fused_dynamic import (
    FusedDynamicPipeline, _bits_i32, pack_layout,
)
from dynslam_tpu_torch.utils.se3 import rotation_angle

from test_torch_fused import assert_map_close
from test_torch_integrate import assert_colors_close
from torch_frontend_inputs import (
    dynamic_slice_config, jax_dynamic_sampler, make_dynamic_frames,
)
from torch_threads import threads

torch_threads = threads(2)

CROPS = {"full": (256, 512), "crop64x96": (64, 96)}


def run_pair(cfg, frames, dispatch_lag=2, check=None):
    """Both pipelines over ``frames`` then ``finalize``; ``check(jp, tp,
    i)`` after every ``process_frame`` (i = frames fed, the finalize
    replays included). Returns (jax pipeline, port pipeline)."""
    jp = JaxDynPipeline(cfg, cfg.calibration, use_pallas=False,
                        dispatch_lag=dispatch_lag)
    tp = build_fused_dynamic(cfg, cfg.calibration, device="cpu",
                             dispatch_lag=dispatch_lag)
    tp.sampler = jax_dynamic_sampler(jp.base_key, tp.K, cfg.vo.ransac_iters,
                                     cfg.tracker.object_ransac_iters)
    for i, (lg, rg, rgb, objid) in enumerate(frames):
        jp.process_frame(lg, rg, rgb, jseg.detections_from_instance_ids(
            objid, min_size_px=8, score=0.98))
        tp.process_frame(lg, rg, rgb, tseg.detections_from_instance_ids(
            objid, min_size_px=8, score=0.98))
        if check is not None:
            check(jp, tp, i)
    jp.finalize()
    tp.finalize()
    if check is not None:
        check(jp, tp, len(frames))
    return jp, tp


def track_table(pipe):
    return {t.id: (t.state.value, t.fused_frames, len(t.frames),
                   t.reconstruction.slot if t.has_reconstruction() else None,
                   t.reconstruction.fused_frames if t.has_reconstruction()
                   else None)
            for t in pipe.tracker.active_tracks.values()}


def assert_words_after(step, ref, got):
    """Packed words after ``step`` fused frames. Through step 3 (the static
    slice test's run length) ``assert_map_close`` holds as it is. The two
    pipelines' poses drift apart by float noise (2e-7 m at step 1, 1.7e-6 m
    at step 5: two Gauss-Newton solvers), and each fused frame rounds a
    few more words to the neighbouring SDF quantum: 99.7% bit-exact after
    step 1, 98.1% after 3, 96.5% after 6. So past step 3 the bit-exact
    share is held at >= 95%, with the weight and one-quantum bounds of
    ``assert_map_close`` unchanged."""
    if step <= 3:
        assert_map_close(ref, got)
        return
    ds = np.abs((ref >> 16) - (got >> 16))
    dw = np.abs((ref & 0xFFFF) - (got & 0xFFFF))
    assert (dw == 0).mean() >= 0.9999, (dw == 0).mean()
    assert (ds <= 1).mean() >= 0.999, (ds <= 1).mean()
    assert (ref == got).mean() >= 0.95, (ref == got).mean()


def _maps_match(jst, tst, step, where):
    valid = np.asarray(jst.valid)
    assert np.array_equal(tst.valid.numpy(), valid), where
    assert np.array_equal(tst.block_coords.numpy(),
                          np.asarray(jst.block_coords)), where
    used = np.nonzero(valid)[0][:-1]  # minus the scratch row
    if used.size:
        assert_words_after(step, np.asarray(jst.tsdf_w)[used],
                           tst.tsdf_w.numpy()[used])
        assert_colors_close(np.asarray(jst.color)[used],
                            tst.color.numpy()[used])
    return used.size


def check_step(jp, tp, i):
    """Tracks, states, slots and fused frames identical; pose within 5 mm
    and 0.05 deg; static and per-slot valid / block_coords exact, packed
    words by ``assert_words_after``; crop origins and fusion clocks
    exact."""
    assert track_table(tp) == track_table(jp), i
    assert len(tp.pose_history) == len(jp.pose_history), i
    for a, b in zip(jp.pose_history, tp.pose_history):
        assert np.abs(a - b).max() < 5e-3, i
    pose, ref = tp.get_pose(), np.asarray(jp.get_pose())
    assert np.abs(pose[:3, 3] - ref[:3, 3]).max() < 5e-3, i
    rot = float(rotation_angle(torch.tensor(
        pose[:3, :3] @ ref[:3, :3].T, dtype=torch.float64)))
    assert np.degrees(rot) < 0.05, i
    jc, tc = jp.carry, tp.carry
    _maps_match(jc.state, tc.state, i, f"static map, step {i}")
    for s in range(tp.S):
        jst = jax.tree_util.tree_map(lambda x: x[s], jc.inst)
        tst = type(tc.inst)(*(getattr(tc.inst, k)[s]
                              for k in tc.inst.__dataclass_fields__))
        _maps_match(jst, tst, i, f"slot {s}, step {i}")
    assert np.array_equal(tc.inst_fidx, np.asarray(jc.inst_fidx)), i
    assert np.array_equal(tc.pending_org, np.asarray(jc.pending_org)), i
    assert np.array_equal(tc.prev_pending_org,
                          np.asarray(jc.prev_pending_org)), i
    assert tp.get_dropped_allocation_count() == \
        jp.get_dropped_allocation_count(), i


@pytest.fixture(scope="module")
def frames():
    return make_dynamic_frames(dynamic_slice_config())


@pytest.mark.parametrize("crop", list(CROPS))
def test_dynamic_slice_matches_jax_with_its_draws(frames, crop):
    cfg = dynamic_slice_config(fusion_crop=CROPS[crop])
    jp, tp = run_pair(cfg, frames, check=check_step)
    assert (tp.crop_h, tp.crop_w) == (jp.crop_h, jp.crop_w)
    # the car goes Dynamic and is reconstructed in a volume of its own
    (t,) = tp.tracker.active_tracks.values()
    assert t.state.value == "Dynamic" and t.has_reconstruction()
    assert t.fused_frames >= 2
    assert t.reconstruction.get_used_block_count() > 100
    assert tp.reconstructed_objects() == [t.id]
    # finalize's two replays drained both pending levels
    assert not (tp.carry.pending_depth > 0).any()
    assert not (tp.carry.prev_pending_depth > 0).any()
    # the object volume renders the car from the last fused frame's camera
    rc = tp.raycast_instance(t.reconstruction.slot,
                             np.linalg.inv(t.get_frame_pose(len(t.frames) - 1)))
    assert (rc.depth > 0).sum() > 50
    preview = tp.composited_preview()
    assert preview.shape == (cfg.frame_height, cfg.frame_width, 3)
    assert (preview != tp.last_outputs.raycast.color.numpy()).any(-1).sum() \
        > 20


def test_pack_layout_is_contiguous():
    layout, total = pack_layout(4)
    cur = 0
    for name, (off, size) in layout.items():
        assert off == cur, name
        cur += size
    # the JAX layout's 38 + 9K + 4 without its relay sync scalar
    assert total == 37 + 9 * 4 + 2 + 2


def _ids(n, wt=320, ht=96):
    objid = np.zeros((ht, wt), np.int16)
    for i in range(n):
        x0 = (i % 16) * 20 + 2
        y0 = 8 + (i // 16) * 44
        objid[y0: y0 + 14, x0: x0 + 14] = i + 1
    return objid


@pytest.mark.parametrize("n", [10, 32])
def test_mask_planes_match_jax(n):
    """uint16 planes past 8 detections, uint32 past 16: the port's bit
    planes equal the JAX package's, byte for byte."""
    objid = _ids(n)
    jd = jseg.detections_from_instance_ids(objid, min_size_px=4)
    td = tseg.detections_from_instance_ids(objid, min_size_px=4)
    assert len(jd) == len(td) == n
    jdb, jcb = JaxDynPipeline.pack_mask_bits(jd, 96, 320, n)
    tdb, tcb = FusedDynamicPipeline.pack_mask_bits(td, 96, 320, n)
    assert tdb.dtype == jdb.dtype == (np.uint16 if n <= 16 else np.uint32)
    assert np.array_equal(tdb, jdb) and np.array_equal(tcb, jcb)


def test_bit31_survives_the_int32_bit_math():
    """Slot 31's bit rides the int32 sign position: ``_bits_i32``
    reinterprets uint32 planes, so the per-slot tests still select exactly
    slot 31's pixels (tests/test_fused_dynamic.py's test, on the port)."""
    objid = _ids(32)
    dets = tseg.detections_from_instance_ids(objid, min_size_px=4)
    db, _ = FusedDynamicPipeline.pack_mask_bits(dets, 96, 320, 32)
    assert db.dtype == np.uint32
    m31 = dets[31].delete_mask.to_full_frame(96, 320)
    bits = _bits_i32(torch.from_numpy(db))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal((((bits >> 31) & 1) == 1).numpy(), m31)
    rem = int(np.int32(np.uint32(1 << 31).view(np.int32)))
    np.testing.assert_array_equal(((bits & rem) != 0).numpy(), m31)
    u16 = torch.from_numpy(np.full((2, 2), 0x8001, np.uint16))
    assert (_bits_i32(u16) == 0x8001).all()
