"""The slice end to end: the port's ``FusedPipeline`` (CPU, plain
versions of the kernels) against the JAX package's ``FusedPipeline``
(``use_pallas=False``) on the tests/test_fused.py scene, with decay
running (``min_decay_age=2``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.config import (
    DynSlamConfig, Intrinsics, MapParams, SceneParams, StereoCalibration,
    StereoMatcherParams, VisualOdometryParams, VoxelDecayParams,
)
from dynslam_tpu.io.synthetic import (
    SyntheticScene, render_stereo_frame, straight_trajectory,
)
from dynslam_tpu.pipeline.fused import FusedPipeline as JaxFusedPipeline
from dynslam_tpu.pipeline.mapping import engine_config_from as jax_ecf
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.pipeline.builder import (
    build_fused_static, engine_config_from,
)
from dynslam_tpu_torch.utils.se3 import rotation_angle

from test_torch_integrate import assert_colors_close
from torch_frontend_inputs import jax_sample_ids
from torch_threads import threads

torch_threads = threads(2)

W, H = 192, 96
N_FRAMES = 4
INTR = Intrinsics(160.0, 160.0, W / 2.0, H / 2.0)
CALIB = StereoCalibration(0.5, 160.0)
CFG = DynSlamConfig(
    frame_width=W, frame_height=H, intrinsics=INTR, calibration=CALIB,
    dynamic_mode=False,
    scene=SceneParams(voxel_size_m=0.08, mu_m=0.32),
    map=MapParams(pool_capacity=16384, local_dims=(80, 32, 80),
                  max_new_blocks_per_frame=4096),
    vo=VisualOdometryParams(max_candidates=1024, max_matches=512,
                            ransac_iters=60, max_disparity=64),
    stereo=StereoMatcherParams(max_disparity=64),
    decay=VoxelDecayParams(enabled=True, min_decay_age=2,
                           max_decay_weight=1),
)
#: the frame whose carry is carried across to the port
CARRY_FRAME = 2


def _np_copy(x):
    return np.array(x, copy=True)


@pytest.fixture(scope="module")
def scene():
    poses = straight_trajectory(N_FRAMES, speed=0.5, yaw_rate=0.004)
    sc = SyntheticScene.default_scene(seed=3)
    frames = []
    for i in range(N_FRAMES):
        fr = render_stereo_frame(sc, poses[i], INTR, CALIB, W, H, frame=i)
        frames.append(tuple(np.clip(fr[k] * 255, 0, 255).astype(np.float32)
                            for k in ("left_gray", "right_gray")))
    return frames, poses


@pytest.fixture(scope="module")
def jax_run(scene):
    """Per-frame records of the JAX pipeline, and its carry (numpy,
    ``convert.FUSED_CARRY_KEYS``) after frame CARRY_FRAME."""
    frames, _ = scene
    pipe = JaxFusedPipeline(jax_ecf(CFG), CFG.stereo, CFG.vo, CFG.decay,
                            CALIB, use_pallas=False)
    recs, carry = [], None
    for i, (lg, rg) in enumerate(frames):
        pipe.process_frame(lg, rg)
        if i == 0:
            continue
        o, st = pipe.last_outputs, pipe.carry.state
        recs.append(dict(
            pose=_np_copy(pipe.get_pose()),
            used=pipe.get_used_block_count(),
            dropped=pipe.get_dropped_allocation_count(),
            freed=int(o.n_freed_blocks),
            tsdf_w=_np_copy(st.tsdf_w), color=_np_copy(st.color),
            valid=_np_copy(st.valid), block_coords=_np_copy(st.block_coords),
            depth=_np_copy(o.raycast.depth), hit=_np_copy(o.raycast.hit),
        ))
        if i == CARRY_FRAME:
            leaves = jax.tree_util.tree_leaves(pipe.carry)
            assert len(leaves) == len(convert.FUSED_CARRY_KEYS)
            carry = {k: _np_copy(v)
                     for k, v in zip(convert.FUSED_CARRY_KEYS, leaves)}
    return recs, carry, pipe.base_key, pipe._frames


def _jax_sampler(base_key):
    def sampler(frame_idx, valid):
        key = jax.random.fold_in(base_key, frame_idx)
        return torch.tensor(jax_sample_ids(key, valid.numpy(),
                                           CFG.vo.ransac_iters))
    return sampler


def assert_map_close(ref: np.ndarray, got: np.ndarray):
    """Packed words of the slice's map. The two pipelines' poses agree to
    float noise (~3e-7 m: two Gauss-Newton solvers), which moves voxel
    projections by an ulp. With the JAX pose fed in, 99.98% of the words
    are bit-exact; with the port's own pose ~98% are, and the rest round
    to the neighbouring SDF quantum or, rarely, a neighbouring pixel. So:
    weights exact, SDF within one quantum on >= 99.9%, >= 97% bit-exact."""
    ds = np.abs((ref >> 16) - (got >> 16))
    dw = np.abs((ref & 0xFFFF) - (got & 0xFFFF))
    assert (dw == 0).mean() >= 0.9999, (dw == 0).mean()
    assert (ds <= 1).mean() >= 0.999, (ds <= 1).mean()
    assert (ref == got).mean() >= 0.97, (ref == got).mean()


def _check_frame(pipe, rec, frame):
    """Pose within 5 mm / 0.05 deg, block counts and integer map state
    exact, packed words by ``assert_map_close``. Returns the raycast's
    (hit, depth) for ``_check_raycasts``."""
    pose = pipe.get_pose()
    assert np.abs(pose[:3, 3] - rec["pose"][:3, 3]).max() < 5e-3, frame
    rot = float(rotation_angle(torch.tensor(
        pose[:3, :3] @ rec["pose"][:3, :3].T, dtype=torch.float64)))
    assert np.degrees(rot) < 0.05, frame
    assert pipe.get_used_block_count() == rec["used"], frame
    assert pipe.get_dropped_allocation_count() == rec["dropped"], frame
    st = pipe.carry.state
    assert np.array_equal(st.valid.numpy(), rec["valid"]), frame
    assert np.array_equal(st.block_coords.numpy(), rec["block_coords"])
    used = np.nonzero(rec["valid"])[0][:-1]
    assert_map_close(rec["tsdf_w"][used], st.tsdf_w.numpy()[used])
    assert_colors_close(rec["color"][used], st.color.numpy()[used])
    rc = pipe.get_raycast()
    return rc.hit.numpy(), rc.depth.numpy()


def _check_raycasts(recs, got, min_hit=0.95):
    """The port renders with the tiled kernel's rule, the JAX CPU path
    with ``tsdf.raycast`` (finer steps, no surface-bearing filter): pooled
    over the frames, >= 95% of the JAX hits are hit (per frame 94.4% to
    97.1%: the misses are thin, once-observed surfaces that the 2.5-voxel
    step floor of the tiled rule passes), at a median depth difference
    under one voxel."""
    jax_hit = np.concatenate([r["hit"].ravel() for r in recs])
    hit = np.concatenate([h.ravel() for h, _ in got])
    assert hit[jax_hit].mean() >= min_hit, hit[jax_hit].mean()
    both = jax_hit & hit
    dd = np.abs(np.concatenate([r["depth"].ravel() for r in recs])
                - np.concatenate([d.ravel() for _, d in got]))[both]
    assert np.median(dd) < CFG.scene.voxel_size_m


def test_slice_matches_jax_with_its_draws(scene, jax_run):
    frames, _ = scene
    recs, _, base_key, _ = jax_run
    pipe = build_fused_static(CFG, CALIB, device="cpu")
    pipe.sampler = _jax_sampler(base_key)
    got = []
    for i, (lg, rg) in enumerate(frames):
        pipe.process_frame(lg, rg)
        if i == 0:
            assert pipe.last_outputs is None
            continue
        got.append(_check_frame(pipe, recs[i - 1], i))
        assert bool(pipe.last_outputs.vo_success)
        assert pipe.last_outputs.host_syncs == 1  # decay on: no hysteresis
        assert pipe.last_outputs.decay_ran
        assert int(pipe.last_outputs.n_freed_blocks) == recs[i - 1]["freed"]
    assert sum(r["freed"] for r in recs) > 0  # decay ran
    _check_raycasts(recs, got)


def test_slice_tracks_ground_truth_with_own_generator(scene):
    """With its own torch.Generator the port's per-step motion is within
    the VO bounds of tests/test_vo.py (4 cm, 0.01 rad)."""
    frames, poses = scene
    pipe = build_fused_static(CFG, CALIB, device="cpu", seed=1)
    prev = None
    for i, (lg, rg) in enumerate(frames):
        pipe.process_frame(lg, rg)
        pose = pipe.get_pose().astype(np.float64)
        if prev is not None:
            delta = pose @ np.linalg.inv(prev)
            gt = np.linalg.inv(poses[i]) @ poses[i - 1]
            assert np.linalg.norm(delta[:3, 3] - gt[:3, 3]) < 0.04, i
            r_err = float(rotation_angle(torch.tensor(
                delta[:3, :3] @ gt[:3, :3].T)))
            assert r_err < 0.01, i
        prev = pose
    assert pipe.get_used_block_count() > 300


def test_carry_from_jax_continues(scene, jax_run):
    """The JAX carry after frame 2, carried across with ``convert``,
    continues in the port: frame 3 agrees with JAX's frame 3."""
    frames, _ = scene
    recs, carry, base_key, jax_frames = jax_run
    pipe = build_fused_static(CFG, CALIB, device="cpu")
    pipe.sampler = _jax_sampler(base_key)
    pipe.carry = convert.fused_carry_from_numpy(carry, "cpu")
    pipe._frames = jax_frames - (N_FRAMES - 1 - CARRY_FRAME)
    back = convert.fused_carry_to_numpy(pipe.carry)
    for k in convert.FUSED_CARRY_KEYS:
        assert np.array_equal(back[k], carry[k]), k
    lg, rg = frames[CARRY_FRAME + 1]
    pipe.process_frame(lg, rg)
    hit, depth = _check_frame(pipe, recs[CARRY_FRAME], CARRY_FRAME + 1)
    _check_raycasts(recs[CARRY_FRAME:], [(hit, depth)], min_hit=0.94)


def test_engine_config_matches_jax():
    assert engine_config_from(CFG) == convert.tsdf_config_from_jax(
        jax_ecf(CFG))


def test_local_window_too_small_is_refused():
    small = CFG.replace(map=MapParams(pool_capacity=1024,
                                      local_dims=(16, 8, 16)))
    with pytest.raises(ValueError, match="too small"):
        build_fused_static(small, CALIB, device="cpu")
