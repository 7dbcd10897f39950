"""``MapEngine`` of the port (CPU, plain versions of K1 and K2) against
the JAX package's (``use_pallas_fusion=False``: the XLA fusion rule K1 is
held to; its Pallas raycast in interpret mode: ``jax_kernel_renders``),
fed the same views at the same ground-truth poses of the
``write_kitti_sequence`` scene at 160x120: integrate, the prepare render,
renders from a free pose off the trajectory and at a past pose, every
``PreviewType``, decay, catch-up and reap counts, ICP, and renders at
half the frame size, which both engines route to the dense tracer."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dynslam_tpu.config import (
    DynSlamConfig, Intrinsics, MapParams, SceneParams, VoxelDecayParams,
)
from dynslam_tpu.io.synthetic import (
    SyntheticScene, render_stereo_frame, straight_trajectory, to_uint8_rgb,
)
from dynslam_tpu.pipeline import mapping as jm
from dynslam_tpu_torch.pipeline import mapping as tm

from test_torch_eval import to_port
from torch_frontend_inputs import RENDER_CAND_K, jax_kernel_renders
from torch_threads import threads

torch_threads = threads(2)

W, H, N = 160, 120, 4
INTR = Intrinsics(0.8 * W, 0.8 * W, W / 2.0, H / 2.0)
CFG = DynSlamConfig(
    frame_width=W, frame_height=H, intrinsics=INTR, right_intrinsics=INTR,
    dynamic_mode=False, max_depth_m=15.0,
    scene=SceneParams(voxel_size_m=0.08, mu_m=0.32),
    map=MapParams(pool_capacity=8192, local_dims=(64, 32, 64),
                  max_new_blocks_per_frame=4096, raycast_fine_steps=48),
    decay=VoxelDecayParams(enabled=True, min_decay_age=2, max_decay_weight=2),
)
#: renders of the two engines (the kernel's rule on both sides) part by
#: float order at a few pixels (PR 4's slice tests measured hit agreement
#: >= 0.9924 and median depth gaps <= 1.6 mm); held to these bounds
MIN_HIT_AGREE, MAX_MEDIAN_GAP_M = 0.99, 5e-3


def staged_views(cfg, n, dynamic=False, seed=0):
    """(rgb uint8, depth int16 mm, cam-to-world) of the
    ``write_kitti_sequence`` scene's first ``n`` frames at ``cfg``'s size,
    the depth clamped as the ELAS dumps are."""
    scene = SyntheticScene.default_scene(with_dynamic=dynamic, seed=seed)
    poses = straight_trajectory(n)
    out = []
    for f in range(n):
        fr = render_stereo_frame(scene, poses[f], cfg.intrinsics,
                                 cfg.calibration, cfg.frame_width,
                                 cfg.frame_height, frame=f)
        d = fr["depth_m"]
        mm = np.where((d >= 0.5) & (d <= 20.0),
                      np.clip(d * 1000.0, 0, 32767), 0).astype(np.int16)
        out.append((to_uint8_rgb(fr["left_gray"]), mm,
                    poses[f].astype(np.float32)))
    return out


def free_pose(c2w: np.ndarray, up=3.0, back=6.0, pitch_deg=15.0):
    """A preview pose off the trajectory: ``up`` m above and ``back`` m
    behind the camera, pitched down."""
    a = np.radians(pitch_deg)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    out = c2w.astype(np.float64).copy()
    out[:3, :3] = c2w[:3, :3] @ rx.T
    out[:3, 3] = c2w[:3, 3] + c2w[:3, :3] @ np.array([0.0, -up, -back])
    return out.astype(np.float32)


def check_render(jr, tr, what, min_hits=0.2):
    """Hit agreement and the median depth gap where both hit."""
    jd, td = np.asarray(jr.depth), tr.depth.numpy()
    agree = ((jd > 0) == (td > 0)).mean()
    both = (jd > 0) & (td > 0)
    assert agree >= MIN_HIT_AGREE, (what, agree)
    assert both.mean() >= min_hits, (what, both.mean())
    assert np.median(np.abs(jd - td)[both]) <= MAX_MEDIAN_GAP_M, what


def assert_words(ref: np.ndarray, got: np.ndarray):
    """Packed words of two maps fused from the same views at the same
    poses: weights exact, >= 99.9% bit-exact, SDF within one quantum."""
    assert ((ref & 0xFFFF) == (got & 0xFFFF)).all()
    assert (ref == got).mean() >= 0.999, (ref == got).mean()
    assert np.abs((ref >> 16) - (got >> 16)).max() <= 1


def assert_states(js, ts):
    for k in ("valid", "block_coords", "alloc_frame", "last_seen",
              "decayed_blocks"):
        assert np.array_equal(np.asarray(getattr(js, k)),
                              getattr(ts, k).numpy()), k
    assert_words(np.asarray(js.tsdf_w), ts.tsdf_w.numpy())
    jc, tc = np.asarray(js.color), ts.color.numpy()
    assert (jc == tc).mean() >= 0.999


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        out = _run()
    assert fill and max(fill) < RENDER_CAND_K
    return out


def _run():
    views = staged_views(CFG, N)
    je = jm.MapEngine(jm.engine_config_from(CFG), CFG.decay, INTR,
                      use_pallas_fusion=False, use_pallas_raycast=True)
    te = tm.MapEngine(tm.engine_config_from(to_port(CFG)),
                      to_port(CFG.decay), to_port(INTR), device="cpu")
    rec = {"freed": []}
    for f, (rgb, mm, c2w) in enumerate(views[:N - 1]):
        w2c = np.linalg.inv(c2w).astype(np.float32)
        for e in (je, te):
            e.set_pose(w2c)
            e.update_view(rgb, mm)
            e.integrate()
            e.prepare_next_step()
        rec["freed"].append((int(je.decay(blocking=True)),
                             int(te.decay(blocking=True))))
        assert_states(je.state, te.state)
        check_render(je.get_raycast(), te.get_raycast(), f"prepare {f}")
    rec["engines"] = (je, te)
    rec["views"] = views
    # every JAX render happens here, under the render patch
    c2w = np.asarray(je.cam_to_world)
    rec["poses"] = {"free": free_pose(c2w), "past": views[0][2]}
    rec["renders"] = {k: je.get_raycast(p) for k, p in rec["poses"].items()}
    rec["previews"] = {p.value: je.get_image(p) for p in jm.PreviewType}
    rec["preview_free"] = je.get_image(jm.PreviewType.COLOR,
                                       rec["poses"]["free"])
    rec["rescaled"] = {k: tuple(e.get_raycast(p, W // 2, H // 2)
                                for e in (je, te))
                       for k, p in (("current", c2w),
                                    ("free", rec["poses"]["free"]))}
    return rec


def test_integrate_and_prepare(run):
    je, te = run["engines"]
    assert te.get_used_block_count() == je.get_used_block_count() > 200
    assert te.get_dropped_allocation_count() == \
        je.get_dropped_allocation_count() == 0
    assert te.frame_idx == je.frame_idx == N - 1
    assert te.get_used_memory_bytes() == je.get_used_memory_bytes()
    assert np.array_equal(te.cam_to_world, np.asarray(je.cam_to_world))


def test_decay_counts(run):
    freed = run["freed"]
    assert all(a == b for a, b in freed), freed
    assert sum(a for a, _ in freed) > 0, freed


def test_free_and_past_pose_renders(run):
    """K2 at a pose whose window lies far from the last frame's: the
    preview pose (3 m up, 6 m back, 15 deg down) and frame 0's pose."""
    je, te = run["engines"]
    for what, pose in run["poses"].items():
        tr = te.get_raycast(pose)
        check_render(run["renders"][what], tr, what, min_hits=0.05)
        assert te.get_float_image(pose).equal(tr.depth)
        # the window moved with the pose: the render is not the cached one
        assert tr is not te.get_raycast()
    a = run["preview_free"]
    b = te.get_image(tm.PreviewType.COLOR, run["poses"]["free"])
    assert (a == b).all(-1).mean() >= MIN_PREVIEW_EQUAL


#: previews equal on this share of pixels: a pixel whose hit flips or whose
#: hit lands in a neighbouring voxel takes another colour (measured 0.9883)
MIN_PREVIEW_EQUAL = 0.98
#: share of pixels whose previews of the two packages are within 2 levels:
#: normals (and the gray shading from them) are differences of neighbouring
#: hit points, so the renders' sub-millimetre float-order gaps move them
#: (measured 0.9666 within 2 levels; 0.79-0.84 exactly equal); depth,
#: colour and weight follow the hit (measured >= 0.9889)
MIN_PREVIEW_CLOSE = {"depth": 0.98, "color": 0.98, "weight": 0.98,
                     "gray": 0.96, "normal": 0.96, "latest_raycast": 0.96}


@pytest.mark.parametrize("preview", list(tm.PreviewType),
                         ids=lambda p: p.value)
def test_previews(run, preview):
    """Each preview equals, exactly, the JAX package's ``get_image`` of the
    port's own render; across the packages, where the renders part by
    float order, within the stated bounds."""
    from dynslam_tpu.ops.tsdf import Raycast as JaxRaycast

    _, te = run["engines"]
    b = te.get_image(preview)
    assert b.shape == (H, W, 3) and b.dtype == np.uint8
    witness = jm.MapEngine.__new__(jm.MapEngine)
    witness.cfg = jm.engine_config_from(CFG)
    witness._last_raycast = JaxRaycast(*(
        jnp.asarray(x.numpy()) for x in te.get_raycast()))
    assert np.array_equal(
        witness.get_image(jm.PreviewType(preview.value)), b)
    a = run["previews"][preview.value]
    close = (np.abs(a.astype(int) - b.astype(int)) <= 2).all(-1).mean()
    assert close >= MIN_PREVIEW_CLOSE[preview.value], (preview, close)
    if preview == tm.PreviewType.COLOR:
        assert (b > 0).any(-1).mean() > 0.3


def test_icp(run):
    """Track the next frame's depth against the prepare render, from a
    perturbed start: the engine's call equals the JAX package's
    ``icp_track`` on the same render (its reference pose, stride and
    intrinsics), and lands near the true pose."""
    from dynslam_tpu.ops import icp as jicp

    _, te = run["engines"]
    rgb, mm, c2w = run["views"][N - 1]
    init = np.linalg.inv(c2w).astype(np.float32)
    init[:3, 3] += [0.02, -0.01, 0.05]
    d = mm.astype(np.float32) / 1000.0
    rt = te.track_icp(d, init_world_to_cam=init)
    rc = te.get_raycast()
    rj = jicp.icp_track(
        jnp.asarray(d), jnp.asarray(rc.points.numpy()),
        jnp.asarray(rc.hit.numpy()),
        jnp.asarray(np.linalg.inv(te.cam_to_world)), jnp.asarray(init),
        jnp.asarray(te.intrinsics_vec.numpy()), stride=4)
    assert bool(rj.success) and bool(rt.success)
    assert np.abs(np.asarray(rj.world_to_cam)
                  - rt.world_to_cam.numpy()).max() <= 1e-4
    true = np.linalg.inv(c2w)
    assert np.abs(rt.world_to_cam.numpy()[:3, 3] - true[:3, 3]).max() < 0.03


def test_catchup_and_reap_counts(run):
    je, te = run["engines"]
    assert te.decay_catchup() == je.decay_catchup()
    assert te.reap(3.0) == je.reap(3.0)
    assert_states(je.state, te.state)
    te.reset()
    assert te.get_used_block_count() == 0 and te.fused_frames == 0


def test_rescaled_render_raises(run):
    """A render at another size than the frame's is the dense tracer in
    both engines (the port raised here while it had no tracer): hit
    agreement and median depth gap within the tracer's bounds
    (``test_torch_dense_raycast.py``), over maps that part by float order
    (``assert_words``)."""
    for what, (jr, tr) in run["rescaled"].items():
        assert tr.depth.shape == (H // 2, W // 2), what
        jd, td = np.asarray(jr.depth), tr.depth.numpy()
        both = (jd > 0) & (td > 0)
        assert ((jd > 0) == (td > 0)).mean() >= 0.999, what
        # the free pose's top-left quarter holds little of the map
        assert both.mean() >= 0.01, what
        assert np.median(np.abs(jd - td)[both]) <= 1e-5, what


def test_config_translators_match_jax():
    from dynslam_tpu.instances.reconstructor import InstanceReconstructor
    from dynslam_tpu_torch import convert

    assert tm.engine_config_from(to_port(CFG)) == \
        convert.tsdf_config_from_jax(jm.engine_config_from(CFG))
    jcfg = InstanceReconstructor(dataclasses.replace(
        CFG, dynamic_mode=True))._instance_cfg
    assert tm.instance_config_from(to_port(CFG)) == \
        convert.tsdf_config_from_jax(jcfg)
    assert jnp.float32(0) == 0  # JAX stays importable beside the port
