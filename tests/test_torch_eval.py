"""The port's evaluation (``dynslam_tpu_torch/eval``) against the JAX
package's on the same inputs: the LIDAR depth counts, the CSV records and
names, the association maps, the compositors, and ``FusedEvaluation``'s
CSV files byte for byte."""

import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu import config as jcfg
from dynslam_tpu.eval import evaluation as jev
from dynslam_tpu.eval import records as jrec
from dynslam_tpu.ops import masks as jmasks
from dynslam_tpu_torch import config as tcfg
from dynslam_tpu_torch.eval import evaluation as tev
from dynslam_tpu_torch.eval import fused_eval as tfe
from dynslam_tpu_torch.eval import records as trec
from dynslam_tpu_torch.ops import masks as tmasks
from torch_threads import threads

torch_threads = threads(2)

H, W = 64, 96
FX, CX, CY, BASE = 80.0, 48.0, 32.0, 0.5
DELTAS = (0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0,
          12.0, 3.0)
KITTI = (False,) * 13 + (True,)


def to_port(obj):
    """A JAX-package configuration object as the port's (its fields)."""
    cls = getattr(tcfg, type(obj).__name__)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = to_port(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def _calib(skewed: bool):
    """(velo_to_cam (4, 4), left (3, 4), right (3, 4)) of the synthetic rig;
    ``skewed`` turns the right camera 0.05 rad in yaw (far points get
    negative disparities) and 0.02 rad in pitch (rows disagree by more
    than 1.2 px: epipolar violations)."""
    K = np.array([[FX, 0, CX], [0, FX, CY], [0, 0, 1.0]])
    Rt = np.eye(4)[:3].copy()
    Rt[0, 3] = -BASE
    if skewed:
        a, b = 0.05, 0.02
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
        Rt[:, :3] = ry @ rx
    v2c = np.array([[0, -1, 0, 0], [0, 0, -1, -0.05], [1, 0, 0, 0.05],
                    [0, 0, 0, 1]], np.float64)
    return v2c, np.hstack([K, np.zeros((3, 1))]), K @ Rt


def _scene(seed: int, far: bool):
    """~20k LIDAR points (velodyne frame) and (rendered, input, assoc)
    maps. The points: 12k on the rendered surface with 10% depth noise,
    and 2k each behind the camera, past max_depth, outside the image and
    at the min_depth edge. The maps hold zeros and values within 0.5 mm
    of a millimetre rounding edge; with ``far`` the rendered depths reach
    21 m, else they stay under 16.38 m."""
    rng = np.random.default_rng(seed)
    hi = 21.0 if far else 16.3
    rend = np.exp(rng.uniform(np.log(0.6), np.log(hi), (H, W)))
    edge = (np.floor(rend * 1000) + 0.5 + rng.choice(
        [-4e-4, -1e-5, 0.0, 1e-5, 4e-4], (H, W))) / 1000
    rend = np.where(rng.random((H, W)) < 0.3, edge, rend).astype(np.float32)
    rend[rng.random((H, W)) < 0.1] = 0
    rend[:8, :20] = 0
    inp = (rend * rng.uniform(0.85, 1.15, (H, W))).astype(np.float32)
    inp = np.minimum(inp, np.float32(16.3 if not far else 24.0))
    inp[rng.random((H, W)) < 0.1] = 0
    inp[-8:, -20:] = 0
    assoc = np.zeros((H, W), np.int8)
    assoc[10:40, 30:70] = 1
    assoc[20:50, 60:90] = 2
    assoc[50:, :25] = 1

    n = 12000
    u = rng.uniform(-0.5, W - 0.5, n)
    v = rng.uniform(-0.5, H - 0.5, n)
    z = rend[np.clip(np.round(v), 0, H - 1).astype(int),
             np.clip(np.round(u), 0, W - 1).astype(int)]
    z = np.where(z > 0, z, rng.uniform(1, 15, n)) * rng.normal(1, 0.1, n)
    parts = [(u, v, z)]
    for lo_u, hi_u, lo_z, hi_z in [(0, W, -8, -0.1), (0, W, 20, 40),
                                   (-60, -1, 1, 15), (0, W, 0.45, 0.55)]:
        m = 2000
        parts.append((rng.uniform(lo_u, hi_u, m), rng.uniform(0, H, m),
                      rng.uniform(lo_z, hi_z, m)))
    u, v, z = (np.concatenate(x) for x in zip(*parts))
    cam = np.stack([(u - CX) / FX * z, (v - CY) / FX * z, z, np.ones_like(z)],
                   1)
    v2c, _, _ = _calib(False)
    velo = (cam @ np.linalg.inv(v2c).T)[:, :3].astype(np.float32)
    return velo, rend, inp, assoc


def _jax(velo, maps, calib, coi):
    v2c, pl, pr = calib
    rend, inp, assoc = maps
    counts, gt = jev.evaluate_depth_jit(
        jnp.asarray(velo), jnp.ones(len(velo), bool),
        jnp.asarray(v2c, jnp.float32), jnp.asarray(pl, jnp.float32),
        jnp.asarray(pr, jnp.float32), jnp.asarray(rend), jnp.asarray(inp),
        jnp.asarray(assoc), jnp.float32(BASE * FX), jnp.float32(0.5),
        jnp.float32(20.0), width=W, height=H, delta_maxes=DELTAS,
        kitti_style=KITTI, compare_on_intersection=coi)
    return np.asarray(counts), np.asarray(gt)


def _port_args(velo, maps, calib):
    v2c, pl, pr = calib
    rend, inp, assoc = maps
    return (torch.from_numpy(velo), torch.tensor(v2c, dtype=torch.float32),
            torch.tensor(np.concatenate([pl, pr]), dtype=torch.float32),
            torch.from_numpy(rend), torch.from_numpy(inp),
            torch.from_numpy(assoc),
            torch.tensor([np.float32(BASE * FX), 0.5, 20.0]))


def _port(velo, maps, calib, coi):
    counts, gt = tev.evaluate_depth(*_port_args(velo, maps, calib), DELTAS,
                                    KITTI, compare_on_intersection=coi)
    return counts.numpy(), gt.numpy()


@pytest.mark.parametrize("coi", [True, False], ids=["intersection", "each"])
@pytest.mark.parametrize("skewed", [False, True], ids=["rig", "skewed"])
def test_evaluate_depth_matches_jax(skewed, coi):
    """Counts and GT stats equal the JAX package's exactly on depths
    under 16.384 m."""
    velo, *maps = _scene(1 + skewed, far=False)
    calib = _calib(skewed)
    jc, jg = _jax(velo, maps, calib, coi)
    tc, tg = _port(velo, maps, calib, coi)
    assert np.array_equal(tc, jc)
    assert np.array_equal(tg, jg)
    # the scene reaches every branch it was made for
    assert jg[2] > 3000 and jc[:, 0, :, 0].min() > 0 and jc[0, 2, 0, 2] > 0
    assert jc[3, 1:, :, :].sum() > 0  # static and dynamic buckets
    if skewed:
        assert jg[0] > 5 and jg[1] > 0  # epipolar, negative disparity
    else:
        assert jg[0] == 0 and jg[1] == 0


@pytest.mark.parametrize("coi", [True, False], ids=["intersection", "each"])
def test_far_rendered_depth_counts_as_the_input_source(coi):
    """Past 16.384 m the JAX package reads a rendered depth back negative
    (an arithmetic shift of the packed word), so it counts an error; the
    port masks the 15 bits. Its fused-source counts equal the JAX
    package's input-source counts with the two maps swapped (the input
    depth's 15 bits unpack right), and its input-source counts equal the
    JAX package's as they are."""
    velo, rend, inp, assoc = _scene(3, far=True)
    calib = _calib(False)
    tc, tg = _port(velo, (rend, inp, assoc), calib, coi)
    jc, jg = _jax(velo, (rend, inp, assoc), calib, coi)
    js, _ = _jax(velo, (inp, rend, assoc), calib, coi)
    assert np.array_equal(tg, jg)
    assert np.array_equal(tc[:, :, 1], jc[:, :, 1])
    assert np.array_equal(tc[:, :, 0], js[:, :, 1])
    # the repair matters on this scene: the JAX fused counts differ
    assert not np.array_equal(tc[:, :, 0], jc[:, :, 0])


def test_packed_vector_matches_jax():
    velo, *maps = _scene(4, far=False)
    v2c, pl, pr = _calib(False)
    rend, inp, assoc = maps
    want = np.asarray(jev.evaluate_depth_packed_jit(
        jnp.asarray(velo), jnp.ones(len(velo), bool),
        jnp.asarray(v2c, jnp.float32), jnp.asarray(pl, jnp.float32),
        jnp.asarray(pr, jnp.float32), jnp.asarray(rend), jnp.asarray(inp),
        jnp.asarray(assoc), jnp.float32(BASE * FX), jnp.float32(0.5),
        jnp.float32(20.0), 4321, 77, width=W, height=H, delta_maxes=DELTAS,
        kitti_style=KITTI))
    args = _port_args(velo, maps, (v2c, pl, pr))
    got = tev.evaluate_depth_packed(*args[:7], 4321, torch.tensor(77),
                                    DELTAS, KITTI).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _name_kw(**kw):
    base = dict(max_decay_weight=1, dataset_id="kitti-odometry-seq",
                frame_offset=0, depth_provider_name="ingraph",
                voxel_size_meters=0.05, max_depth_meters=20.0,
                is_dynamic=True, direct_refinement=False,
                use_depth_weighting=False, fusion_every=1,
                base_folder="csv")
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    {}, dict(is_dynamic=False), dict(use_depth_weighting=True),
    dict(fusion_every=3), dict(voxel_size_meters=0.035, frame_offset=12),
    dict(max_decay_weight=7, max_depth_meters=8.0, base_folder="/x/y"),
    dict(direct_refinement=True),
], ids=str)
def test_csv_names_match_jax(kw):
    for fn in ("base_csv_name", "depth_csv_name", "static_depth_csv_name",
               "dynamic_depth_csv_name", "tracking_csv_name",
               "memory_csv_name"):
        assert getattr(trec, fn)(**_name_kw(**kw)) == \
            getattr(jrec, fn)(**_name_kw(**kw))


def test_records_match_jax():
    def each(make):
        return make(jrec, jcfg), make(trec, tcfg)

    r = each(lambda m, c: m.DepthResult(10, 3, 4, 3, 2))
    e = [m.DepthEvaluation(3.0, x, x, True) for m, x in zip((jrec, trec), r)]
    f = [m.DepthFrameEvaluation(7, "seq", 20.0, [x, x])
         for m, x in zip((jrec, trec), e)]
    for a, b in (r, e, f,
                 each(lambda m, c: m.TrackerFrameEntry(5, 2, 1, 3, 1, 40)),
                 each(lambda m, c: m.MemoryUsageEntry(
                     4, 1 << 20, 4096, c.VoxelDecayParams())),
                 each(lambda m, c: m.TrackletEvaluation(3, 1, 0.25, 0.01))):
        assert a.get_header() == b.get_header()
        assert a.get_data() == b.get_data()
    assert r[1].correct_pixel_ratio(False) == r[0].correct_pixel_ratio(False)
    with pytest.raises(ValueError):
        trec.DepthResult(10, 3, 4, 2, 2)


def _mask_dets(K):
    """K square detections over a 96x320 frame (one more for K = 4: a
    non-reconstructable one)."""
    from dynslam_tpu.io.segmentation import detections_from_instance_ids \
        as jdets
    from dynslam_tpu_torch.io.segmentation import \
        detections_from_instance_ids as tdets

    objid = np.zeros((96, 320), np.int16)
    for i in range(K):
        x0, y0 = (i % 16) * 19 + 2, 8 + (i // 16) * 40
        objid[y0: y0 + 26, x0: x0 + 26] = i + 1  # neighbours overlap
    return jdets(objid, min_size_px=4), tdets(objid, min_size_px=4)


@pytest.mark.parametrize("K", [4, 16, 32])
def test_assoc_maps_match_jax(K):
    """``assoc_bits_to_map`` from uint8/16/32 planes equals the JAX
    package's and ``build_association_map`` on the host."""
    from dynslam_tpu.instances.track import TrackState as JState
    from dynslam_tpu.pipeline.fused_dynamic import (
        FusedDynamicPipeline as JPipe, assoc_bits_to_map as j_bits,
    )
    from dynslam_tpu_torch.instances.track import TrackState as TState
    from dynslam_tpu_torch.pipeline.fused_dynamic import (
        FusedDynamicPipeline as TPipe, assoc_bits_to_map as t_bits,
    )

    jd, td = _mask_dets(K)
    assert len(jd) == len(td) == K
    pick = [JState.DYNAMIC, JState.UNCERTAIN, None, JState.STATIC]
    jstates = {id(d): pick[i % 4] for i, d in enumerate(jd)
               if pick[i % 4] is not None}
    tstates = {id(d): getattr(TState, pick[i % 4].name)
               for i, d in enumerate(td) if pick[i % 4] is not None}
    host_j = jev.build_association_map(
        96, 320, SimpleNamespace(instance_detections=jd), None,
        det_states=jstates)
    host_t = tev.build_association_map(
        96, 320, SimpleNamespace(instance_detections=td), None,
        det_states=tstates)
    assert np.array_equal(host_t, host_j)
    assert set(np.unique(host_j)) == {0, 1, 2}

    _, jcb = JPipe.pack_mask_bits(jd, 96, 320, K)
    _, tcb = TPipe.pack_mask_bits(td, 96, 320, K)
    assert tcb.dtype == {4: np.uint8, 16: np.uint16, 32: np.uint32}[K]
    codes = np.asarray([
        tev.ASSOC_DYNAMIC if d.is_reconstructable() and jstates.get(id(d))
        not in (None, JState.UNCERTAIN) else tev.ASSOC_SKIP for d in jd],
        np.int8)
    want = np.asarray(j_bits(jnp.asarray(jcb), jnp.asarray(codes), K))
    got = t_bits(torch.from_numpy(tcb), torch.from_numpy(codes), K).numpy()
    assert got.dtype == np.int8
    assert np.array_equal(got, want)
    assert np.array_equal(got, host_j)


def test_composite_many_match_jax_and_the_sequential_merge():
    rng = np.random.default_rng(5)
    S, h, w = 4, 20, 24
    depths = np.where(rng.random((S, h, w)) < 0.5, 0,
                      rng.choice([1.0, 2.0, 2.5, 3.0], (S, h, w))
                      ).astype(np.float32)
    target = np.where(rng.random((h, w)) < 0.3, 0,
                      rng.choice([1.5, 2.0, 2.5], (h, w))).astype(np.float32)
    colors = rng.integers(0, 256, (S, h, w, 3), dtype=np.uint8)
    tcol = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    tints = rng.uniform(0, 255, (S, 3)).astype(np.float32)
    active = np.array([True, False, True, True])
    jd = np.asarray(jmasks.composite_depth_many(target, depths, active))
    td = tmasks.composite_depth_many(
        torch.from_numpy(target), torch.from_numpy(depths),
        torch.from_numpy(active))
    assert np.array_equal(td.numpy(), jd)
    jc, jdd = jmasks.composite_color_many(tcol, target, colors, depths,
                                          tints, active)
    tc, tdd = tmasks.composite_color_many(*(torch.from_numpy(x) for x in (
        tcol, target, colors, depths, tints, active)))
    seq_c, seq_d = torch.from_numpy(tcol), torch.from_numpy(target)
    for s in range(S):
        d = torch.from_numpy(depths[s] if active[s] else 0 * depths[s])
        seq_c, seq_d = tmasks.composite_color(
            seq_c, seq_d, torch.from_numpy(colors[s]), d,
            torch.from_numpy(tints[s]))
    for got, ref in ((tc, np.asarray(jc)), (tdd, np.asarray(jdd)),
                     (tc, seq_c.numpy()), (tdd, seq_d.numpy())):
        assert np.array_equal(got.numpy(), ref)


def test_composite_many_without_a_mask_takes_every_slot():
    rng = np.random.default_rng(6)
    S, h, w = 3, 12, 16
    depths = torch.from_numpy(np.where(
        rng.random((S, h, w)) < 0.5, 0, rng.uniform(1, 3, (S, h, w))
    ).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 3, (h, w)).astype(np.float32))
    colors = torch.from_numpy(rng.integers(0, 256, (S, h, w, 3),
                                           dtype=np.uint8))
    tcol = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    tints = torch.from_numpy(rng.uniform(0, 255, (S, 3)).astype(np.float32))
    every = torch.ones(S, dtype=torch.bool)
    assert torch.equal(tmasks.composite_depth_many(target, depths),
                       tmasks.composite_depth_many(target, depths, every))
    for got, ref in zip(
            tmasks.composite_color_many(tcol, target, colors, depths, tints),
            tmasks.composite_color_many(tcol, target, colors, depths, tints,
                                        every)):
        assert torch.equal(got, ref)


# -- FusedEvaluation -------------------------------------------------------

SEQ_W, SEQ_H, SEQ_FRAMES = 160, 120, 4


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    from dynslam_tpu.io.synthetic import write_kitti_sequence

    root = str(tmp_path_factory.mktemp("evalseq") / "seq")
    write_kitti_sequence(root, num_frames=SEQ_FRAMES, width=SEQ_W,
                         height=SEQ_H, with_dynamic=True,
                         write_velodyne=True)
    return root


def _evaluations(root, csv_jax, csv_port, **eval_kw):
    """The JAX package's and the port's FusedEvaluation of ``root``."""
    from dynslam_tpu.eval.fused_eval import FusedEvaluation as JEval
    from dynslam_tpu.io.calib import read_kitti_calibration
    from dynslam_tpu.io.depth_providers import InGraphDepthProvider
    from dynslam_tpu.io.input import Input, kitti_odometry_config
    from dynslam_tpu_torch.pipeline.builder import attach_evaluation

    calib = read_kitti_calibration(os.path.join(root, "calib.txt"))
    icfg = kitti_odometry_config()
    cfg = jcfg.DynSlamConfig(
        frame_width=SEQ_W, frame_height=SEQ_H,
        intrinsics=calib.left_color_intrinsics,
        calibration=calib.stereo_calibration(),
        evaluation=jcfg.EvaluationParams(**eval_kw))
    inp = Input(root, icfg, InGraphDepthProvider(), (SEQ_W, SEQ_H),
                cfg.calibration)
    jeval = JEval(root, icfg, inp, calib, cfg, csv_out_dir=csv_jax)
    pipe = SimpleNamespace(device=torch.device("cpu"))
    teval = attach_evaluation(pipe, to_port(cfg), root, csv_out_dir=csv_port)
    return jeval, teval


def _frame_inputs(f):
    """Frame f's (rendered, input, assoc, used, decayed); depths under
    16 m, half the frames with an association map."""
    rng = np.random.default_rng(100 + f)
    rend = rng.uniform(0.5, 16.0, (SEQ_H, SEQ_W)).astype(np.float32)
    rend[rng.random((SEQ_H, SEQ_W)) < 0.2] = 0
    inp = (rend * rng.uniform(0.9, 1.1, rend.shape)).astype(np.float32)
    assoc = None
    if f % 2:
        assoc = np.zeros((SEQ_H, SEQ_W), np.int8)
        assoc[30:90, 40:120] = 1
        assoc[50:70, 60:100] = 2
    return rend, inp, assoc, 1000 + 7 * f, 3 * f


def _csv_files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_fused_evaluation_csvs_byte_identical(sequence, tmp_path):
    jeval, teval = _evaluations(sequence, str(tmp_path / "jax"),
                                str(tmp_path / "port"))
    for f in range(1, SEQ_FRAMES + 1):  # the last frame has no LIDAR scan
        rend, inp, assoc, used, decayed = _frame_inputs(f)
        jeval.submit(f, jnp.asarray(rend), jnp.asarray(inp), assoc, used,
                     decayed)
        teval.submit(f, torch.from_numpy(rend), torch.from_numpy(inp),
                     assoc, torch.tensor(used), decayed)
        for ev in (jeval, teval):
            ev.log_tracker(f, 2, 1, 0)
    jeval.close()
    teval.close()
    want = _csv_files(tmp_path / "jax")
    got = _csv_files(tmp_path / "port")
    assert len(want) == 5 and list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert teval.failed_fetches == 0 and len(teval.job_ms) == SEQ_FRAMES - 1


def test_fused_evaluation_failed_fetch_degrades_loudly(sequence, tmp_path,
                                                       monkeypatch, capsys):
    """A failing background fetch degrades each frame to a synchronous
    retry, with a warning a frame and a count at close, and every row
    still lands in frame order (tests/test_fused_eval.py's test)."""
    def dead_fetch(packed):
        raise RuntimeError("simulated fetch error")

    monkeypatch.setattr(tfe, "_fetch", dead_fetch)
    _, teval = _evaluations(sequence, str(tmp_path / "j"),
                            str(tmp_path / "port"))
    for f in (1, 2, 3):
        rend, inp, assoc, used, decayed = _frame_inputs(f)
        teval.submit(f, torch.from_numpy(rend), torch.from_numpy(inp),
                     assoc, used, decayed)
    teval.close()
    err = capsys.readouterr().err
    assert "eval fetch thread failed" in err
    assert "eval background fetches failed" in err
    assert teval.failed_fetches == 3
    for suffix, key in (("unified-depth-result.csv", "frame"),
                        ("memory.csv", "frame_id")):
        (name,) = [n for n in os.listdir(tmp_path / "port")
                   if n.endswith(suffix)]
        rows = open(tmp_path / "port" / name).read().splitlines()
        assert rows[0].split(",")[0] == key
        assert [int(r.split(",")[0]) for r in rows[1:]] == [1, 2, 3]


def test_fused_evaluation_rejects_delay(sequence, tmp_path):
    with pytest.raises(ValueError, match="evaluation_delay"):
        _evaluations(sequence, str(tmp_path / "j"), str(tmp_path / "p"),
                     evaluation_delay=2)


def test_direct_refinement_in_the_name(sequence, tmp_path):
    """The port writes the configuration's flag into the CSV names, as the
    reference does (the JAX package always writes NO-direct-ref)."""
    from dynslam_tpu_torch.pipeline.builder import attach_evaluation

    cfg = tcfg.DynSlamConfig(frame_width=SEQ_W, frame_height=SEQ_H,
                             use_direct_refinement=True)
    ev = attach_evaluation(SimpleNamespace(device=torch.device("cpu")), cfg,
                           sequence, csv_out_dir=str(tmp_path))
    assert "-with-direct-ref-" in ev.csv_unified.output_path
    ev.close()


@pytest.mark.parametrize("name,args", [
    ("kitti_odometry_config", ()), ("kitti_odometry_dispnet_config", ()),
    ("kitti_odometry_lowres_config", (0.5,)),
    ("kitti_tracking_config", (7,)), ("kitti_tracking_dispnet_config", (7,)),
])
def test_input_presets_match_jax(name, args):
    from dynslam_tpu.io import input as jin
    from dynslam_tpu_torch.io import input as tin

    assert dataclasses.asdict(getattr(tin, name)(*args)) == \
        dataclasses.asdict(getattr(jin, name)(*args))


def test_evaluation_method_matches_jax(sequence, tmp_path):
    """``Evaluation.evaluate_depth`` (the synchronous form, a scan read
    from the sequence) gives the JAX package's counts."""
    jeval, teval = _evaluations(sequence, str(tmp_path / "j"),
                                str(tmp_path / "p"))
    rend, inp, assoc, _, _ = _frame_inputs(1)
    lidar = teval.velodyne.read_frame(1)
    want = jeval.evaluate_depth(lidar, rend, inp, assoc)
    got = teval.evaluate_depth(lidar, rend, inp, assoc)
    assert np.array_equal(got, want) and want[3, 0, :, 2].sum() > 0
    for ev in (jeval, teval):
        ev.close()
