"""The static slice with evaluation on, end to end: the port's
``FusedPipeline`` with ``FusedEvaluation`` attached (CPU, plain versions
of the kernels, the JAX package's RANSAC draws) against the JAX package's
(its Pallas raycast in interpret mode: ``jax_kernel_renders``) over 5
frames of the ``write_kitti_sequence`` scene at 160x120, each submitting
every frame as ``main.run_fused`` does."""

import csv
import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch

from dynslam_tpu.config import (
    DynSlamConfig, EvaluationParams, Intrinsics, MapParams, SceneParams,
    StereoCalibration, StereoMatcherParams, VisualOdometryParams,
    VoxelDecayParams,
)
from dynslam_tpu.pipeline.fused import FusedPipeline as JaxFusedPipeline
from dynslam_tpu.pipeline.mapping import engine_config_from as jax_ecf
from dynslam_tpu_torch.pipeline.builder import (
    attach_evaluation, build_fused_static,
)

from test_torch_eval import to_port
from torch_frontend_inputs import (
    RENDER_CAND_K, jax_fused_evaluation, jax_kernel_renders, jax_sample_ids,
    write_eval_sequence,
)
from torch_threads import threads

torch_threads = threads(2)

W, H, N_FRAMES = 160, 120, 5
INTR = Intrinsics(0.8 * W, 0.8 * W, W / 2.0, H / 2.0)
#: max_depth 8 m as tests/test_fused_eval.py's static test; it also keeps
#: every render under 16.384 m, past which the JAX package's packed lookup
#: reads the rendered depth back wrong (``eval/evaluation.py``)
CFG = DynSlamConfig(
    frame_width=W, frame_height=H, intrinsics=INTR, right_intrinsics=INTR,
    calibration=StereoCalibration(0.5, INTR.fx), dynamic_mode=False,
    max_depth_m=8.0,
    scene=SceneParams(voxel_size_m=0.05, mu_m=0.3),
    map=MapParams(pool_capacity=16384, local_dims=(80, 32, 80),
                  max_new_blocks_per_frame=4096),
    vo=VisualOdometryParams(max_candidates=1024, max_matches=512,
                            ransac_iters=60, max_disparity=64),
    stereo=StereoMatcherParams(max_disparity=64),
    decay=VoxelDecayParams(enabled=True, min_decay_age=2, max_decay_weight=1),
    evaluation=EvaluationParams(enabled=True, semantic_evaluation=True),
)
#: Both packages render with the kernel's rule: the JAX package its Pallas
#: raycast in interpret mode with candidate lists long enough that no tile
#: drops a block (``jax_kernel_renders``), the port K2's plain version, whose
#: bitmap drops none. The renders then differ by float order only, at a
#: handful of pixels. Every column that depends on the render stays within
#: these bounds:
#: - a fused-source field differs by at most max(5, 3% of the frame's
#:   evaluated points of its bucket);
#: - an input-source error, missing or correct count (taken on the
#:   intersection with the render's valid pixels) differs by at most the
#:   points that one render hits and the other misses (``render_flips``),
#:   and those are within the same max(5, 3%).
#: Measured on these scenes (static slice, dynamic at lag 1 and 2): at most
#: 3 fused points a field, and at most 7 flipped points a frame and bucket
#: (the static slice's frame 4, of 320).
#: ``check_witness`` shows that the render is the only cause: every column
#: of the port's CSVs, input source included, equals exactly what the JAX
#: package's evaluation writes for the port's render, the JAX pipeline's
#: input depth and association map.
SLACK_N, SLACK_SHARE = 5, 0.03
#: ``check_renders``' bounds
MIN_HIT_AGREE, MAX_MEDIAN_GAP_M = 0.99, 5e-3
#: columns that do not depend on the render: equal
EXACT = ("fusion-total-", "input-total-", "input-missing-separate-")
#: input-source columns taken on the intersection with the render
ON_RENDER = ("input-error-", "input-missing-", "input-correct-")
BUCKETS = ("unified", "static", "dynamic")


def _rows(text):
    return list(csv.DictReader(io.StringIO(text)))


class SubmitLog:
    """Wraps an evaluation's ``submit``: keeps each frame's rendered depth,
    input depth and association map (host copies; the static pipeline's
    map, None, as zeros)."""

    def __init__(self, evaluation):
        self.fn, self.frames = evaluation.submit, {}
        evaluation.submit = self

    def __call__(self, n, rendered, input_depth, assoc, *rest):
        r = np.array(rendered)
        self.frames[n] = (r, np.array(input_depth),
                          np.zeros(r.shape, np.int8) if assoc is None
                          else np.array(assoc))
        return self.fn(n, rendered, input_depth, assoc, *rest)


def render_flips(jax_log, port_log, evaluation):
    """{frame: (3,) per bucket}: the frame's evaluated LIDAR points that
    one package's render hits and the other's misses, counted by the
    port's ``evaluate_depth`` with the JAX render as the fused source and
    the port's as the input source on their intersection:
    2 joint-missing - missing(JAX) - missing(port)."""
    out = {}
    for n, (jr, _, _) in jax_log.frames.items():
        tr, _, assoc = port_log.frames[n]
        c = evaluation.evaluate_depth(
            evaluation.velodyne.read_frame(n), jr, tr, assoc)[0]
        out[n] = 2 * c[:, 0, 1] - c[:, 0, 3] - c[:, 1, 3]
    return out


@dataclasses.dataclass
class SliceRun:
    """One run of both pipelines over a slice: the CSV directories, the
    port's pipeline, the JAX package's evaluation, both submit logs (JAX,
    port), each JAX render's largest per-tile candidate count, and
    ``render_flips``; the dynamic slice adds its stash logs."""
    jdir: str
    tdir: str
    tp: object
    jax_eval: object
    renders: tuple
    fill: list
    flips: dict
    stash: tuple = ()


def check_fill(fill) -> None:
    """No JAX render's tile filled its ``RENDER_CAND_K`` candidates (a
    full list may have dropped a block the port's render keeps)."""
    assert fill, "no JAX render reported its candidate counts"
    assert max(fill) < RENDER_CAND_K, (
        f"a tile's candidate list reached {max(fill)} blocks, RENDER_CAND_K "
        f"is {RENDER_CAND_K} (largest count of each render: {fill})")


def render_agreement(jax_log, port_log, region=None) -> dict:
    """{frame: (hit agreement, median depth gap m where both hit, or None
    where they share no hit)} over the frame or, with ``region`` set, over
    the pixels whose association code is ``region``."""
    out = {}
    for n, (jr, _, _) in jax_log.frames.items():
        tr, _, assoc = port_log.frames[n]
        m = np.ones(jr.shape, bool) if region is None else assoc == region
        both = (jr > 0) & (tr > 0) & m
        gap = float(np.median(np.abs(jr - tr)[both])) if both.any() else None
        out[n] = (float(((jr > 0) == (tr > 0))[m].mean()), gap)
    return out


def check_renders(jax_log, port_log, region=None) -> None:
    """The two packages' evaluated renders agree pixel by pixel
    (``render_agreement``): hit agreement and the median depth gap where
    both hit (measured: >= 0.9924 and <= 1.6 mm on every frame of the
    three slices; a render 2% too deep or a crop merged at the wrong place
    parts by far more)."""
    got = render_agreement(jax_log, port_log, region)
    bad = {n: v for n, v in got.items() if not (
        v[0] >= MIN_HIT_AGREE and (v[1] is None or v[1] <= MAX_MEDIAN_GAP_M))}
    assert not bad, (
        f"region {region}: (hit agreement, median gap m) of the frames out "
        f"of bounds {bad} (need >= {MIN_HIT_AGREE} and <= "
        f"{MAX_MEDIAN_GAP_M}); every frame: {got}")


def witness_rows(jax_eval, frame, counts) -> list:
    """One frame's CSV rows, per bucket, as the JAX package's
    ``Evaluation.write_frame_rows`` formats ``counts`` (``records.py``)."""
    rows = []
    for bi in range(len(BUCKETS)):
        row = {"frame": str(frame)}
        for di, dmax in enumerate(jax_eval._all_deltas):
            k = "-kitti" if jax_eval._kitti_flags[di] else ""
            for si, src in enumerate(("fusion", "input")):
                err, miss, ok, sep = (int(x) for x in counts[di, bi, si])
                for field, v in (("total", err + miss + ok), ("error", err),
                                 ("missing", miss), ("correct", ok),
                                 ("missing-separate", sep)):
                    row[f"{src}-{field}-{dmax:.2f}{k}"] = str(v)
        rows.append(row)
    return rows


def check_witness(jax_eval, jax_log, port_log, port_dir) -> None:
    """The association maps equal the JAX pipeline's, and every row of the
    port's depth CSVs equals, field for field, the JAX package's
    evaluation of the port's render with the JAX pipeline's input depth
    and association map: the render alone parts the two packages' rows."""
    port = {}
    for name in os.listdir(port_dir):
        for bi, b in enumerate(BUCKETS):
            if name.endswith(f"-{b}-depth-result.csv"):
                for r in _rows(open(os.path.join(port_dir, name)).read()):
                    port[int(r["frame"]), bi] = r
    assert port, f"no depth CSVs in {port_dir}"
    assert port_log.frames.keys() == jax_log.frames.keys(), (
        f"evaluated frames: port {sorted(port_log.frames)}, JAX "
        f"{sorted(jax_log.frames)}")
    for n, (_, jin, jassoc) in jax_log.frames.items():
        tr, _, tassoc = port_log.frames[n]
        assert np.array_equal(tassoc, jassoc), (
            f"frame {n}: association maps differ at "
            f"{int((tassoc != jassoc).sum())} pixels")
        counts = jax_eval.evaluate_depth(
            jax_eval.velodyne.read_frame(n), tr, jin, jassoc)
        for bi, want in enumerate(witness_rows(jax_eval, n, counts)):
            got = port.get((n, bi))
            assert got is not None, f"frame {n}, {BUCKETS[bi]}: no port row"
            diff = [(k, got.get(k), v) for k, v in want.items()
                    if got.get(k) != v]
            diff += [(k, got[k], None) for k in got if k not in want]
            assert not diff, (
                f"frame {n}, {BUCKETS[bi]}: {len(diff)} fields differ, the "
                f"first {diff[0][0]}: port {diff[0][1]}, witness "
                f"{diff[0][2]}")


def compare_csv_dirs(jax_dir, port_dir, flips) -> None:
    """File names, headers, frame sets, the memory and tracker files and
    the columns that do not depend on the render (``EXACT``) equal; the
    rest within the bounds above (``flips``: ``render_flips``)."""
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        want = open(os.path.join(jax_dir, name)).read()
        got = open(os.path.join(port_dir, name)).read()
        assert got.splitlines()[0] == want.splitlines()[0], name
        if not name.endswith("-depth-result.csv"):  # memory, tracker
            lines = list(zip(got.splitlines(), want.splitlines()))
            first = next(((i, a, b) for i, (a, b) in enumerate(lines)
                          if a != b), None)
            assert got == want, (
                f"{name}: line (index, port, JAX) {first}" if first else
                f"{name}: {len(got.splitlines())} lines vs "
                f"{len(want.splitlines())}")
            continue
        (bucket,) = [i for i, b in enumerate(BUCKETS)
                     if f"-{b}-depth" in name]
        jr, tr = _rows(want), _rows(got)
        assert [r["frame"] for r in tr] == [r["frame"] for r in jr], name
        for a, b in zip(jr, tr):
            slack = max(SLACK_N, SLACK_SHARE * int(a["input-total-0.50"]))
            flip = int(flips[int(a["frame"])][bucket])
            assert flip <= slack, (
                f"{name} frame {a['frame']}: {flip} points flip between "
                f"the renders (slack {slack})")
            for col in a:
                where = (name, a["frame"], col, a[col], b[col])
                if col == "frame" or col.startswith(EXACT):
                    assert a[col] == b[col], where
                elif col.startswith(ON_RENDER):
                    assert abs(int(a[col]) - int(b[col])) <= flip, where
                else:
                    assert abs(int(a[col]) - int(b[col])) <= slack, where


def unified(csv_dir):
    (name,) = [n for n in os.listdir(csv_dir)
               if n.endswith("-unified-depth-result.csv")]
    return {int(r["frame"]): r
            for r in _rows(open(os.path.join(csv_dir, name)).read())}


@pytest.fixture(scope="module")
def run(tmp_path_factory) -> SliceRun:
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        out = _run(tmp_path_factory)
    # a copy: the next run in this process empties the shared list
    out.fill = list(fill)
    return out


def _run(tmp_path_factory) -> SliceRun:
    root = str(tmp_path_factory.mktemp("evalstatic") / "seq")
    frames = write_eval_sequence(root, CFG, N_FRAMES, dynamic=False)
    jdir, tdir = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "port"))
    jp = JaxFusedPipeline(jax_ecf(CFG), CFG.stereo, CFG.vo, CFG.decay,
                          CFG.calibration, use_pallas=True)
    jp.evaluation = jax_fused_evaluation(root, CFG, jdir)
    pcfg = to_port(CFG)
    tp = build_fused_static(pcfg, pcfg.calibration, device="cpu")

    def sampler(frame_idx, valid):
        key = jax.random.fold_in(jp.base_key, frame_idx)
        return torch.tensor(jax_sample_ids(key, valid.numpy(),
                                           CFG.vo.ransac_iters))

    tp.sampler = sampler
    attach_evaluation(tp, pcfg, root, csv_out_dir=tdir)
    logs = SubmitLog(jp.evaluation), SubmitLog(tp.evaluation)
    for n, (lg, rg, rgb, _) in enumerate(frames):
        for pipe in (jp, tp):
            pipe.process_frame(lg, rg, rgb)
            o = pipe.last_outputs
            if o is not None:
                pipe.evaluation.submit(n, o.raycast.depth, o.depth_m, None,
                                       o.used_blocks, o.decayed_blocks)
    jp.evaluation.close()
    tp.evaluation.close()
    return SliceRun(jdir, tdir, tp, jp.evaluation, logs, [],
                    render_flips(*logs, tp.evaluation))


def test_static_render_candidates_fit(run):
    check_fill(run.fill)


def test_static_renders_agree(run):
    check_renders(*run.renders)


def test_static_witness_rows(run):
    check_witness(run.jax_eval, *run.renders, run.tdir)


def test_static_slice_csvs_match_jax(run):
    tdir, tp = run.tdir, run.tp
    compare_csv_dirs(run.jdir, tdir, run.flips)
    uni = unified(tdir)
    assert sorted(uni) == list(range(1, N_FRAMES)), sorted(uni)
    # the fused map is exact ground truth's render: most points correct at
    # the KITTI rule from the second fused frame on
    for f in range(2, N_FRAMES):
        r = uni[f]
        ok = int(r["fusion-total-3.00-kitti"]) \
            - int(r["fusion-missing-3.00-kitti"])
        assert int(r["fusion-correct-3.00-kitti"]) >= 0.9 * ok > 0, (
            f"frame {f}: {r['fusion-correct-3.00-kitti']} correct of {ok} "
            "points the render hits (need 90%)")
    assert tp.evaluation.failed_fetches == 0
    assert len(tp.evaluation.job_ms) == N_FRAMES - 1, tp.evaluation.job_ms

