"""The staged slice end to end: the port's ``DynSlam`` built by
``build_dynslam`` (CPU, plain versions of the kernels, the JAX package's
RANSAC draws through the scene-flow provider's ``sampler``) against the
JAX package's (its fusion the XLA rule K1 is held to, its renders the
Pallas raycast in interpret mode: ``jax_kernel_renders``), over a
``write_kitti_sequence`` folder with evaluation on: the static slice with
scene-flow odometry at evaluation delay 0, and with ICP odometry at delay
2. The dynamic slice is in ``test_torch_dynslam_dynamic.py``. Frame by
frame: poses, track states and the static map; at the end the CSVs, the
composited preview and the trajectory the CLI would write."""

import csv
import dataclasses
import io
import os
import types

import jax
import numpy as np
import pytest
import torch

from dynslam_tpu.config import (
    DynSlamConfig, EvaluationParams, MapParams, SceneParams,
    StereoMatcherParams, VisualOdometryParams, VoxelDecayParams,
)
from dynslam_tpu.io.synthetic import write_kitti_sequence
from dynslam_tpu.pipeline import builder as jb
from dynslam_tpu.pipeline.mapping import PreviewType as JPreview
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.pipeline import builder as tb
from dynslam_tpu_torch.pipeline.mapping import PreviewType
from dynslam_tpu_torch.utils.se3 import rotation_angle

from test_torch_eval import to_port
from test_torch_fused import assert_map_close
from test_torch_mapping import check_render
from torch_frontend_inputs import (
    RENDER_CAND_K, jax_kernel_renders, jax_sample_ids,
)
from torch_threads import threads

torch_threads = threads(2)

W, H, N_FRAMES = 160, 120, 5
#: tests/test_torch_eval_slice.py's static configuration (max_depth 8 m
#: keeps every render under 16.384 m, past which the JAX package's packed
#: lookup reads the rendered depth back wrong)
CFG = DynSlamConfig(
    dynamic_mode=False, max_depth_m=8.0,
    scene=SceneParams(voxel_size_m=0.05, mu_m=0.3),
    map=MapParams(pool_capacity=16384, local_dims=(80, 32, 80),
                  max_new_blocks_per_frame=4096),
    vo=VisualOdometryParams(max_candidates=1024, max_matches=512,
                            ransac_iters=60, max_disparity=64),
    stereo=StereoMatcherParams(max_disparity=64),
    decay=VoxelDecayParams(enabled=True, min_decay_age=2, max_decay_weight=1),
    evaluation=EvaluationParams(enabled=True, semantic_evaluation=True),
)
#: the poses of the two packages part by float order in two Gauss-Newton
#: solvers: ~1e-6 m a frame with scene-flow odometry (PR 2)
MAX_POSE_GAP_M, MAX_ROT_GAP_DEG = 5e-3, 0.05
#: with ICP odometry the two packages' poses part by centimetres from frame
#: 2 on, and by how much depends on the CPU thread count (1.5-4.5 cm at
#: frame 2, 7.1-24.1 cm at frame 3 at 1-6 torch threads, measured): the
#: frame-1 poses part by float order in the scene-flow egomotion (1.5e-7 to
#: 6.0e-7 m), so the maps and the prepare renders part a little, and ICP,
#: which this corridor constrains weakly along its forward axis (walls and
#: road run along it), turns that into centimetres. So no cross-package
#: pose bound holds the ICP frames; each step is held to the JAX package
#: on the port's own state instead: the render ICP tracks against
#: (``check_render``), the call (``icp_track`` within ``ICP_ATOL``) and the
#: map it fuses (``assert_map_close``, and word for word)
ICP_ATOL = 1e-4
#: a CSV field that depends on the render: within max(5, 3% of the frame's
#: evaluated points of its bucket) (PR 4's bound for the fused slices);
#: the columns that do not depend on it, and the memory and tracker files,
#: are equal
SLACK_N, SLACK_SHARE = 5, 0.03
EXACT = ("frame", "fusion-total-", "input-total-", "input-missing-separate-")
#: the composited previews' covered (non-black) pixels agree on this share
#: (measured 0.9856). Their colours are not compared across the packages:
#: the two renders' depths part by a median 1.2 mm but by 6.7 cm at the
#: 90th percentile (measured; PR 4's render bounds hold the median only),
#: and a hit 5 cm off reads another voxel's colour
MIN_COVER_AGREE = 0.98
MAX_P90_GAP_M = 0.1


def jax_sampler(base_key, iters):
    """The port's ``sampler`` fed the JAX provider's draws."""
    def sampler(index, valid):
        return torch.tensor(jax_sample_ids(
            jax.random.fold_in(base_key, index), valid.numpy(), iters))
    return sampler


def assert_pose_close(a, b, what):
    assert np.abs(a[:3, 3] - b[:3, 3]).max() < MAX_POSE_GAP_M, what
    rot = float(rotation_angle(torch.tensor(
        a[:3, :3] @ b[:3, :3].T, dtype=torch.float64)))
    assert np.degrees(rot) < MAX_ROT_GAP_DEG, what


class IcpLog:
    """Wraps an engine's ``track_icp``: keeps each call's inputs (depth,
    initial pose, the render it tracks against and its pose) and result."""

    def __init__(self, engine):
        self.fn, self.engine, self.calls = engine.track_icp, engine, []
        engine.track_icp = self

    def __call__(self, depth_m, init_world_to_cam=None, stride=4):
        e = self.engine
        rc = e._last_raycast
        res = self.fn(depth_m, init_world_to_cam=init_world_to_cam,
                      stride=stride)
        self.calls.append(dict(
            depth=np.array(depth_m), init=np.array(init_world_to_cam),
            points=rc.points.numpy().copy(), hit=rc.hit.numpy().copy(),
            render=rc.depth.clone(), c2w=e._last_raycast_pose.copy(),
            ref=np.linalg.inv(e._last_raycast_pose),
            intr=e.intrinsics_vec.numpy().copy(),
            out=res.world_to_cam.numpy().copy(), ok=bool(res.success)))
        return res


class MapLog:
    """Wraps an engine's ``integrate``: keeps, by frame index, the map
    before and after each fusion (JAX field names) and the view and pose
    it fused."""

    def __init__(self, engine):
        self.fn, self.engine, self.fused = engine.integrate, engine, {}
        engine.integrate = self

    @staticmethod
    def _state(state):
        return {k: v.copy()
                for k, v in convert.tsdf_state_to_numpy(state).items()}

    def __call__(self):
        e = self.engine
        rec = dict(before=self._state(e.state), w2c=e.pose_w2c.copy(),
                   c2w=e.cam_to_world.copy(), fidx=e.frame_idx,
                   rgb=e._view_rgb.numpy().copy(),
                   depth=e._view_depth_m.numpy().copy())
        self.fn()
        rec["after"] = self._state(e.state)
        self.fused[rec["fidx"]] = rec


def _rows(path):
    return list(csv.DictReader(io.StringIO(open(path).read())))


def compare_csvs(jdir, tdir):
    names = sorted(os.listdir(jdir))
    assert names and sorted(os.listdir(tdir)) == names
    for name in names:
        want = open(os.path.join(jdir, name)).read()
        got = open(os.path.join(tdir, name)).read()
        if not name.endswith("-depth-result.csv"):
            assert got == want, name  # memory, tracker
            continue
        jr, tr = _rows(os.path.join(jdir, name)), _rows(os.path.join(tdir,
                                                                     name))
        assert [r["frame"] for r in tr] == [r["frame"] for r in jr], name
        for a, b in zip(jr, tr):
            slack = max(SLACK_N, SLACK_SHARE * int(a["input-total-0.50"]))
            for col in a:
                where = (name, a["frame"], col, a[col], b[col])
                if col.startswith(EXACT):
                    assert a[col] == b[col], where
                else:
                    assert abs(int(a[col]) - int(b[col])) <= slack, where


def run_both(tmp_path_factory, cfg, n, dynamic, size=(W, H),
             write_dispnet=False, prepare=None, **build):
    """Both packages' staged pipelines over one ``write_kitti_sequence``
    folder of ``size`` (with DispNet PFMs if ``write_dispnet``; then
    ``prepare(root)``, if given), frame by frame, with the render patch
    on. Returns per-frame records (poses, tracks, used blocks, the map's
    words, each frame's input depth in mm and the depth the map was
    given) and the end state."""
    root = str(tmp_path_factory.mktemp("staged") / "seq")
    write_kitti_sequence(root, num_frames=n, width=size[0], height=size[1],
                         with_dynamic=dynamic, write_dispnet=write_dispnet)
    if prepare is not None:
        prepare(root)
    jdir, tdir = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "port"))
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        jd, ji = jb.build_dynslam(root, cfg, with_evaluation=True,
                                  csv_out_dir=jdir, **build)
        jd.static_scene.use_pallas_fusion = False
        jd.static_scene.use_pallas_raycast = True
        if jd.instance_reconstructor is not None:
            jd.instance_reconstructor.volume_pool._use_pallas_raycast = True
        td, ti = tb.build_dynslam(root, to_port(cfg), with_evaluation=True,
                                  csv_out_dir=tdir, device="cpu", **build)
        td.sparse_sf_provider.sampler = jax_sampler(
            jd.sparse_sf_provider._base_key, cfg.vo.ransac_iters)
        icp = IcpLog(td.static_scene)
        # with ICP odometry, the maps its renders come from
        maps = None if cfg.external_odometry else MapLog(td.static_scene)
        recs = []
        while jd.process_frame(ji):
            assert td.process_frame(ti)
            tracks = [
                {t.id: (t.state.value, t.has_reconstruction(),
                        len(t.frames))
                 for t in d.instance_reconstructor.tracker.active_tracks
                 .values()} if d.instance_reconstructor else {}
                for d in (jd, td)]
            recs.append(dict(
                poses=(np.asarray(jd.get_current_pose()),
                       td.get_current_pose()),
                tracks=tracks,
                used=(jd.static_scene.get_used_block_count(),
                      td.static_scene.get_used_block_count()),
                words=(np.array(jd.static_scene.state.tsdf_w),
                       td.static_scene.state.tsdf_w.numpy().copy()),
                depth_mm=(np.array(ji.get_images()[1]),
                          np.array(ti.get_images()[1])),
                view_depth=(np.array(jd.static_scene._view_depth_m),
                            td.static_scene._view_depth_m.numpy().copy())))
        assert not td.process_frame(ti)
        previews = (jd.get_static_map_raycast_preview(
            preview=JPreview.COLOR),
            td.get_static_map_raycast_preview(preview=PreviewType.COLOR))
        renders = (jd.static_scene.get_raycast(),
                   td.static_scene.get_raycast())
        for d in (jd, td):
            d.finalize()
            d.evaluation.close()
    assert fill and max(fill) < RENDER_CAND_K
    return dict(recs=recs, previews=previews, renders=renders,
                dirs=(jdir, tdir),
                dyn=(jd, td), root=root, icp=icp.calls,
                maps=maps and maps.fused)


def check_run(res, n):
    recs = res["recs"]
    assert len(recs) == n
    for f, r in enumerate(recs):
        assert_pose_close(*r["poses"], f)
        assert r["tracks"][0] == r["tracks"][1], f
        assert r["used"][0] == r["used"][1], f
        assert_map_close(*r["words"])
    assert recs[-1]["used"][1] > 300
    assert not res["icp"]  # the VO never failed
    compare_csvs(*res["dirs"])
    a, b = res["previews"]
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert ((a > 0).any(-1) == (b > 0).any(-1)).mean() >= MIN_COVER_AGREE
    check_render(*res["renders"], "last prepare render")
    # the renders' tails: the kernel's rule on both sides, yet a tenth of
    # the pixels part by centimetres (measured 6.7 cm at the 90th
    # percentile on the static slice)
    jr, tr = res["renders"]
    jd, tdp = np.asarray(jr.depth), tr.depth.numpy()
    both = (jd > 0) & (tdp > 0)
    assert np.percentile(np.abs(jd - tdp)[both], 90) <= MAX_P90_GAP_M
    jd, td = res["dyn"]
    assert len(td.pose_history) == len(jd.pose_history) == n + 1
    assert td.static_scene.get_dropped_allocation_count() == 0
    # the timing report names the stages the JAX package names
    names = {ln.split()[0] for ln in td.get_timing_report().splitlines()}
    assert {"0-total-frame", "3-scene-flow-vo", "6-static-fusion",
            "9-evaluation"} <= names


def test_static_slice_matches_jax(tmp_path_factory):
    """Scene-flow odometry, evaluation delay 2: each evaluated frame is
    rendered at its own, past pose and its input depth re-read."""
    delay = 2
    cfg = dataclasses.replace(CFG, evaluation=dataclasses.replace(
        CFG.evaluation, evaluation_delay=delay))
    res = run_both(tmp_path_factory, cfg, N_FRAMES, dynamic=False)
    check_run(res, N_FRAMES)
    _, tdir = res["dirs"]
    (uni,) = [nm for nm in os.listdir(tdir)
              if nm.endswith("unified-depth-result.csv")]
    rows = _rows(os.path.join(tdir, uni))
    assert [int(r["frame"]) for r in rows] == list(range(N_FRAMES - delay))
    # the fused map is exact ground truth's: most points correct at the
    # KITTI rule once a frame has been fused
    for r in rows[1:]:
        ok = int(r["fusion-total-3.00-kitti"]) \
            - int(r["fusion-missing-3.00-kitti"])
        assert int(r["fusion-correct-3.00-kitti"]) >= 0.9 * ok > 0, r["frame"]


def _jax_state(arrays):
    from dynslam_tpu.ops import tsdf as jt
    import jax.numpy as jnp

    return jt.TsdfState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def render_witness(jeng, rec, call, what):
    """(a) The render the port's ICP call tracked against, beside JAX's
    Pallas raycast (interpret mode, ``RENDER_CAND_K`` candidates) of the
    port's map that render came from, at the same pose, its visible blocks
    listed at the pose the fusion set (as the prepare render reuses
    them)."""
    import dynslam_tpu.ops.pallas_raycast as jpr
    from dynslam_tpu.ops import tsdf as jt
    import jax.numpy as jnp

    assert np.array_equal(rec["c2w"], call["c2w"]), what
    js = _jax_state(rec["after"])
    c2w = jnp.asarray(rec["c2w"])
    origin = jt.compute_origin(jeng.cfg, c2w)
    grid = jt.build_local_grid(jeng.cfg, js, origin)
    slots, mask = jt.visible_blocks(jeng.cfg, js, grid, origin,
                                    jnp.asarray(rec["w2c"]))
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        jr = jpr.raycast_tiled(jeng.cfg, js, slots, mask, origin, c2w,
                               jnp.asarray(call["intr"]))
        jax.effects_barrier()
        assert fill and max(fill) < RENDER_CAND_K, what
    check_render(jr, types.SimpleNamespace(depth=call["render"]), what)


def map_witness(jeng, rec, what):
    """(b) The port's map after fusing a frame, beside JAX's XLA fusion
    (the rule K1 is held to) of the port's map before it, with the port's
    view, pose and frame index: allocation exact, the words within
    ``assert_map_close`` and, on these same inputs, equal word for word
    (measured at 1-6 torch threads; one ulp of K1's 1/mu moves ~0.03% of
    the observed words by a quantum)."""
    import jax.numpy as jnp

    jeng.state = _jax_state(rec["before"])
    jeng.set_pose(rec["w2c"])
    jeng.set_view_device(jnp.asarray(rec["rgb"]), jnp.asarray(rec["depth"]))
    jeng.frame_idx = rec["fidx"]
    jeng.integrate()
    got = rec["after"]
    for k in ("valid", "block_coords", "alloc_frame", "last_seen"):
        assert np.array_equal(np.asarray(getattr(jeng.state, k)), got[k]), \
            (what, k)
    want = np.asarray(jeng.state.tsdf_w)
    assert_map_close(want, got["tsdf_w"])
    assert np.array_equal(want, got["tsdf_w"]), \
        (what, int((want != got["tsdf_w"]).sum()))


def test_icp_odometry_slice(tmp_path_factory):
    """``external_odometry`` off: ICP against the prepare render from frame
    2 on, seeded at constant velocity; evaluation delay 0. Frames 0-1 (no
    ICP) are held to the JAX package's poses; from frame 2 every input of
    every ICP call is held to JAX on the port's own state (the render
    witness; the depth is the sequence's; the initial pose is the port's
    own constant-velocity seed), the call itself to JAX's ``icp_track``,
    the frame's pose to the call's result, and the map fused at that pose
    to JAX's fusion (the map witness). The packages' pose gap is printed,
    not bounded (``ICP_ATOL``'s comment says why)."""
    from dynslam_tpu.ops import icp as jicp
    import jax.numpy as jnp

    n = 4
    cfg = dataclasses.replace(CFG, external_odometry=False)
    res = run_both(tmp_path_factory, cfg, n, dynamic=False)
    recs, calls, maps = res["recs"], res["icp"], res["maps"]
    assert len(calls) == n - 2 and all(c["ok"] for c in calls)
    for c in calls:
        want = jicp.icp_track(*(jnp.asarray(c[k]) for k in (
            "depth", "points", "hit", "ref", "init", "intr")), stride=4)
        assert bool(want.success)
        assert np.abs(np.asarray(want.world_to_cam) - c["out"]).max() \
            <= ICP_ATOL
    jeng = res["dyn"][0].static_scene
    gaps = []
    for f, r in enumerate(recs):
        a, b = r["poses"]
        gaps.append(float(np.abs(a[:3, 3] - b[:3, 3]).max()))
        if f < 2:
            assert gaps[-1] < MAX_POSE_GAP_M, f
            continue
        # the frame's pose is its ICP result, composed as the JAX package
        # composes it
        call = calls[f - 2]
        assert np.allclose(b, call["out"], atol=1e-6), f
        render_witness(jeng, maps[f - 1], call, f"frame {f} render")
        map_witness(jeng, maps[f], f"frame {f} map")
    print("max |dt| port vs JAX by frame (m):", gaps)
    jdir, tdir = res["dirs"]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        if name.endswith("-depth-result.csv"):
            for a, b in zip(_rows(os.path.join(jdir, name)),
                            _rows(os.path.join(tdir, name))):
                assert [a[k] for k in a if k.startswith(EXACT)] == \
                    [b[k] for k in a if k.startswith(EXACT)], name
