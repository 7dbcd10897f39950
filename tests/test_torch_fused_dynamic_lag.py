"""The dynamic slice at dispatch lag 1 against the JAX package, the port's
lag 2 against its lag 1 (tests/test_fused_dynamic.py's
``test_dispatch_lag2_matches_lag1``), and a JAX carry carried across by
``convert`` continuing in the port's step."""

import jax
import numpy as np
import pytest
import torch

import dynslam_tpu.pipeline.fused_dynamic as jfd
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.io import segmentation as tseg
from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic
from dynslam_tpu_torch.pipeline.fused_dynamic import (
    Routing, _bits_i32, fused_dynamic_step,
)

from test_torch_fused import assert_map_close
from test_torch_fused_dynamic import check_step, run_pair
from torch_frontend_inputs import (
    DYN_FRAMES, dynamic_slice_config, jax_dynamic_sampler,
    make_dynamic_frames,
)
from torch_threads import threads

torch_threads = threads(2)

#: the JAX dispatch whose input carry is carried across (the carry after
#: frame 3)
CARRY_FRAME_IDX = 4


def _np(x):
    return np.array(x, copy=True)


@pytest.fixture(scope="module")
def lag1():
    """Both pipelines at lag 1, checked after every frame; records the
    JAX step's inputs and outputs at dispatch CARRY_FRAME_IDX."""
    cfg = dynamic_slice_config()
    frames = make_dynamic_frames(cfg)
    rec = {}
    orig = jfd.fused_dynamic_step

    def recording(*args, **kw):
        carry = args[10]
        hit = int(carry.frame_idx) == CARRY_FRAME_IDX
        if hit:
            rec["carry_in"] = [_np(x) for x in jax.tree_util.tree_leaves(
                carry)]
            rec["args"] = args[:10] + tuple(_np(a) for a in args[11:17])
            rec["kw"] = kw
        out = orig(*args, **kw)
        if hit:
            rec["carry_out"] = [_np(x) for x in jax.tree_util.tree_leaves(
                out[0])]
            rec["packed"] = _np(out[1].packed)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "fused_dynamic_step", recording)
        jp, tp = run_pair(cfg, frames, dispatch_lag=1, check=check_step)
    return cfg, frames, jp, tp, rec


def test_lag1_matches_jax(lag1):
    _, _, jp, tp, _ = lag1
    (t,) = tp.tracker.active_tracks.values()
    assert t.state.value == "Dynamic" and t.fused_frames >= 2
    assert not (tp.carry.pending_depth > 0).any()


def test_lag2_matches_lag1(lag1):
    """Lag 2 dispatches frame k before it finishes frame k-1: the same
    tracking outcome, at most one fused view fewer, identical VO, both
    pending levels drained, static maps of similar size."""
    cfg, frames, _, p1, _ = lag1
    p2 = build_fused_dynamic(cfg, cfg.calibration, device="cpu",
                             dispatch_lag=2)
    p2.sampler = jax_dynamic_sampler(jax.random.PRNGKey(0), p2.K,
                                     cfg.vo.ransac_iters,
                                     cfg.tracker.object_ransac_iters)
    for lg, rg, rgb, objid in frames:
        p2.process_frame(lg, rg, rgb, tseg.detections_from_instance_ids(
            objid, min_size_px=8, score=0.98))
    p2.finalize()
    (t1,) = p1.tracker.active_tracks.values()
    (t2,) = p2.tracker.active_tracks.values()
    assert t2.state.value == "Dynamic" and t2.has_reconstruction()
    assert t2.fused_frames >= t1.fused_frames - 1 >= 1
    n1 = t1.reconstruction.get_used_block_count()
    assert t2.reconstruction.get_used_block_count() > 0.5 * n1
    for k in range(1, DYN_FRAMES + 1):
        d = np.linalg.norm(p1.pose_history[k][:3, 3]
                           - p2.pose_history[k][:3, 3])
        assert d < 1e-4, k
    assert not (p2.carry.pending_depth > 0).any()
    assert not (p2.carry.prev_pending_depth > 0).any()
    assert 0.8 * p1.get_used_block_count() < p2.get_used_block_count() \
        < 1.25 * p1.get_used_block_count()


def test_jax_carry_continues_in_port(lag1):
    """The JAX carry after frame 3 — static map, object pool, pending
    crops — converted with ``convert`` and stepped by the port with the
    routing JAX dispatched, agrees with JAX's next carry."""
    cfg, _, jp, tp, rec = lag1
    keys = convert.FUSED_DYN_CARRY_KEYS
    assert len(rec["carry_in"]) == len(keys)
    arrays = dict(zip(keys, rec["carry_in"]))
    carry = convert.fused_dyn_carry_from_numpy(arrays, "cpu")
    back = convert.fused_dyn_carry_to_numpy(carry)
    for k in keys:
        assert np.array_equal(back[k], arrays[k]), k
    assert carry.inst.tsdf_w.shape[0] == tp.S

    args = rec["args"]
    lg, rg, rgb, db, cb, route = args[10:16]
    RL, _ = jfd.route_layout(tp.K, tp.S)

    def get(name):
        o, n = RL[name]
        return route[o: o + n]

    routing = Routing(
        copy_bbox=get("copy_bbox").reshape(tp.K, 4),
        mask_gate=get("mask_gate") > 0.5, warm_tr=get("warm_tr").reshape(
            tp.K, 6), action=np.round(get("action")).astype(np.int32),
        slot_src=np.round(get("slot_src")).astype(np.int32),
        fuse_pose=get("fuse_pose").reshape(tp.S, 4, 4),
        slot_reset=get("slot_reset") > 0.5, slot_reap_w=get("slot_reap_w"),
        max_decay_weight=float(get("max_decay_weight")[0]),
        min_decay_age=int(round(float(get("min_decay_age")[0]))))
    assert (routing.slot_src >= 0).any()  # a routed fusion is in the step
    carry2, outs = fused_dynamic_step(
        tp.cfg, tp.icfg_fuse, tp.stereo_params, tp.vo_params,
        tp.obj_params, args[6], args[7], tp.K, tp.S, carry,
        torch.from_numpy(lg), torch.from_numpy(rg), torch.from_numpy(rgb),
        _bits_i32(torch.from_numpy(db)), _bits_i32(torch.from_numpy(cb)),
        routing, tp.calib_vec, tp.intr_vec, tp.intr_host, tp.bf,
        sampler=jax_dynamic_sampler(jp.base_key, tp.K, cfg.vo.ransac_iters,
                                    cfg.tracker.object_ransac_iters),
        fuse_from_prev=rec["kw"].get("fuse_from_prev", False))
    got = convert.fused_dyn_carry_to_numpy(carry2)
    want = dict(zip(keys, rec["carry_out"]))
    assert np.abs(got["pose_w2c"] - want["pose_w2c"]).max() < 5e-3
    for k in ("frame_idx", "inst_fidx", "pending_org", "prev_pending_org",
              "state.valid", "state.block_coords", "inst.valid",
              "inst.block_coords", "inst.alloc_frame", "inst.last_seen"):
        assert np.array_equal(got[k], want[k]), k
    for pre in ("state", "inst"):
        valid = want[f"{pre}.valid"]
        assert_map_close(want[f"{pre}.tsdf_w"][valid],
                         got[f"{pre}.tsdf_w"][valid])
    # the cut crops: the same pixels hold depth
    assert ((got["pending_depth"] > 0) == (want["pending_depth"] > 0)).mean() \
        > 0.999
    # the per-mask object motions of the packed outputs
    jl, _ = jfd.pack_layout(tp.K)
    tl = tp._layout
    packed = outs.packed.numpy()
    for name in ("obj_success", "obj_count"):
        (jo, n), (to, _) = jl[name], tl[name]
        assert np.array_equal(packed[to: to + n], rec["packed"][jo: jo + n])
    (jo, n), (to, _) = jl["obj_tr"], tl["obj_tr"]
    assert np.abs(packed[to: to + n] - rec["packed"][jo: jo + n]).max() < 1e-3
