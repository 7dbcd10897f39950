"""Set-up shared by the port's bench (``dynslam_tpu_torch/bench.py``), its
scripts and ``chip_smoke.py``: the bench's sequences and configuration
(``ensure_seq``, ``load_frames``, ``bench_config``; ``bench.py:69-146``),
frames of synthetic scenes rendered in one pool of worker processes and
cached under ``dynslam_tpu_torch/_build/`` (``render_sets``), and the
profiler's summary by stage. The timing modes are the bench's.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

#: the bench's frame size, sequence length and scene (bench.py:41-67):
#: building rows, the camera's speed (m) and yaw (rad) a frame, the seed,
#: the dynamic scene's cars and recurring oncoming ones
W, H = 1242, 375
N_FRAMES = 40
SCENE_ROWS = 11
SPEED, YAW_RATE, SEED = 0.8, 0.003, 11
N_DYNAMIC, RECURRING = 3, 2
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def bench_scene(dynamic: bool) -> dict:
    """``SyntheticScene.default_scene`` arguments of a bench scene (those
    ``write_kitti_sequence`` passes for bench.py's sequences: the static
    scene ignores ``n_dynamic``)."""
    if dynamic:
        return dict(with_dynamic=True, seed=SEED, n_dynamic=N_DYNAMIC,
                    n_rows=SCENE_ROWS, recurring_oncoming=RECURRING)
    return dict(seed=SEED, n_rows=SCENE_ROWS)


def bench_config(dynamic: bool, k4: bool = False,
                 min_decay_age: int = 200):
    """bench.py ``bench_config``: 1242x375 KITTI intrinsics, voxel 5 cm,
    pool 2^17 blocks, window 160x48x160, stereo range 128, decay of
    weight-1 voxels older than ``min_decay_age`` frames; the dynamic one
    with the shipped ``InstanceMapParams`` (8 volumes, 16 mask slots), or
    a quarter of it with ``k4``."""
    from dynslam_tpu_torch.config import (
        DynSlamConfig, InstanceMapParams, MapParams, SceneParams,
        StereoMatcherParams, VisualOdometryParams, VoxelDecayParams,
    )

    imp = InstanceMapParams()
    if k4:
        imp = InstanceMapParams(max_objects=4, max_detections=4)
    intr, calib = bench_intrinsics()
    return DynSlamConfig(
        frame_width=W, frame_height=H, intrinsics=intr, calibration=calib,
        dynamic_mode=dynamic,
        scene=SceneParams(voxel_size_m=0.05, mu_m=0.30),
        map=MapParams(pool_capacity=2 ** 17, local_dims=(160, 48, 160),
                      max_new_blocks_per_frame=8192),
        instance_map=imp,
        stereo=StereoMatcherParams(max_disparity=128),
        vo=VisualOdometryParams(),
        decay=VoxelDecayParams(enabled=True, min_decay_age=min_decay_age,
                               max_decay_weight=1),
    )


def bench_intrinsics():
    """(intrinsics, stereo calibration) of the bench rig (bench.py:80-81):
    KITTI's 1242x375 camera."""
    from dynslam_tpu_torch.config import Intrinsics, StereoCalibration

    return (Intrinsics(707.0912, 707.0912, W / 2.0, 183.1104),
            StereoCalibration(0.537150654273, 707.0912))


def seq_set(dynamic: bool, n_frames: int = N_FRAMES) -> "RenderSet":
    """The ``RenderSet`` of a bench sequence: the frames ``ensure_seq``
    writes, with each frame's LIDAR scan."""
    from dynslam_tpu_torch.io import synthetic as syn

    intr, calib = bench_intrinsics()
    return RenderSet(
        f"bench_seq-{'dyn' if dynamic else 'static'}-{W}x{H}-n{n_frames}"
        f"-s{SEED}-r{SCENE_ROWS}-v{SPEED}-y{YAW_RATE}"
        + (f"-dyn{N_DYNAMIC}-rec{RECURRING}" if dynamic else ""),
        syn.straight_trajectory(n_frames, speed=SPEED, yaw_rate=YAW_RATE),
        bench_scene(dynamic), intr, calib, W, H,
        keep=("left", "right", "depth", "objid", "velodyne"))


def seq_root(dynamic: bool, n_frames: int = N_FRAMES) -> str:
    return str(BUILD_DIR / (f"bench_seq_{'dyn' if dynamic else 'static'}_"
                            f"{W}x{H}x{n_frames}"))


def write_seq(root: str, rset: "RenderSet", frames: dict) -> None:
    """``render_sets``' frames of ``rset``, LIDAR scans included, as a
    KITTI-layout folder (``write_kitti_frames``, no ELAS dumps): the files
    ``write_kitti_sequence`` writes for the same scene, poses and
    camera."""
    from dynslam_tpu_torch.io import synthetic as syn

    def rgb(gray):
        return np.repeat(gray[..., None], 3, axis=-1)

    syn.write_kitti_frames(
        root, syn.SyntheticScene.default_scene(**rset.scene),
        np.asarray(rset.poses),
        syn.make_calibration(rset.intrinsics, rset.calib),
        (dict(left=rgb(frames["left"][f]), right=rgb(frames["right"][f]),
              depth_m=frames["depth"][f], object_id=frames["objid"][f],
              velodyne=frames["velodyne"][f][:frames["velodyne_n"][f]])
         for f in range(len(rset.poses))),
        with_dynamic=rset.scene.get("with_dynamic", False),
        write_elas_xml=False)


def ensure_seq(dynamic: bool, root: Optional[str] = None,
               n_frames: int = N_FRAMES,
               frames: Optional[dict] = None) -> str:
    """The bench scene as a KITTI-layout sequence with LIDAR scans and
    MNC dumps (the inputs the reference's own loop reads), written once
    under ``_build/`` (or ``root``) and kept: what ``write_kitti_sequence``
    writes for bench.py's arguments (``bench.py:69-96``), its frames
    rendered in ``render_sets``' process pool (or taken from ``frames``,
    that pool's output for ``seq_set``)."""
    root = root or seq_root(dynamic, n_frames)
    marker = os.path.join(root, ".bench_complete")
    if os.path.exists(marker):
        return root
    rset = seq_set(dynamic, n_frames)
    if frames is None:
        print(f"[bench_setup] rendering the "
              f"{'dynamic' if dynamic else 'static'} bench sequence into "
              f"{root} (once, ~20 s a frame on each core)", file=sys.stderr)
        frames = render_sets([rset])[0]
    shutil.rmtree(root, ignore_errors=True)
    write_seq(root, rset, frames)
    open(marker, "w").close()
    return root


def load_frames(root: str, n_frames: int = N_FRAMES, seed=None):
    """Gray stereo frames from the sequence's PNGs (``cv2.imread(...,
    IMREAD_GRAYSCALE)``'s rule) with fresh +-1 noise (``seed`` None: OS
    entropy), as bench.py reads them: (left, right) uint8 stacks."""
    from dynslam_tpu_torch.io.images import read_png_gray

    left = np.stack([read_png_gray(os.path.join(root, "image_2",
                                                f"{f:06d}.png"))
                     for f in range(n_frames)])
    right = np.stack([read_png_gray(os.path.join(root, "image_3",
                                                 f"{f:06d}.png"))
                      for f in range(n_frames)])
    rng = np.random.default_rng(seed)

    def noise(a):
        return np.clip(a.astype(np.int16) + rng.integers(
            -1, 2, a.shape, dtype=np.int16), 0, 255).astype(np.uint8)
    return noise(left), noise(right)


class RenderSet(NamedTuple):
    """Frames of one synthetic scene: the cache file's name, the camera
    poses (n, 4, 4; pose i renders at frame index i), ``default_scene``
    arguments, intrinsics, stereo calibration, size, the gray rule
    (``round``: ``to_uint8_rgb``, ``trunc``: ``clip(g * 255).astype(
    uint8)``, ``float``: ``clip(g * 255)`` as float32) and the outputs
    kept (``_render_one``)."""

    key: str
    poses: np.ndarray
    scene: dict
    intrinsics: object
    calib: object
    width: int
    height: int
    gray: str = "round"
    keep: tuple = ("left", "right", "depth", "objid")


def _gray(gray: np.ndarray, rule: str) -> np.ndarray:
    if rule == "round":
        return np.clip(gray * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if rule == "float":
        return np.clip(gray * 255, 0, 255).astype(np.float32)
    return np.clip(gray * 255, 0, 255).astype(np.uint8)


#: points of a LIDAR scan ``make_velodyne_points`` keeps at most
VELODYNE_POINTS = 20000


def _render_one(args):
    """One stereo frame: the ``keep`` entries of (left, right) gray by
    ``rule``, depth, the ids of the scene's dynamic boxes (0 elsewhere),
    the true disparity and the LIDAR scan ``write_kitti_sequence`` writes
    (``velodyne``: padded to ``VELODYNE_POINTS`` rows, with its length
    as ``velodyne_n``)."""
    from dynslam_tpu_torch.io import synthetic as syn

    frame, pose, intr, calib, width, height, scene_kw, rule, keep = args
    scene = syn.SyntheticScene.default_scene(**scene_kw)
    fr = syn.render_stereo_frame(scene, pose, intr, calib, width, height,
                                 frame=frame)
    dyn_ids = [i + 1 for i, b in enumerate(scene.boxes) if b.is_dynamic]
    objid = np.where(np.isin(fr["object_id"], dyn_ids), fr["object_id"], 0)
    out = dict(left=_gray(fr["left_gray"], rule),
               right=_gray(fr["right_gray"], rule),
               depth=fr["depth_m"].astype(np.float32),
               objid=objid.astype(np.int16), disparity=fr["disparity"])
    out = {k: out[k] for k in keep if k != "velodyne"}
    if "velodyne" in keep:
        pts = syn.make_velodyne_points(
            fr["depth_m"], intr,
            syn.make_calibration(intr, calib).velo_to_left_cam,
            max_points=VELODYNE_POINTS)
        out["velodyne"] = np.zeros((VELODYNE_POINTS, 4), np.float32)
        out["velodyne"][:len(pts)] = pts
        out["velodyne_n"] = np.int64(len(pts))
    return out


def render_sets(sets, cache_dir: Path = BUILD_DIR):
    """Render every set's frames not cached yet, all in one pool of
    spawned processes, one a core (in this process for fewer than 4
    Mpixels in all), and cache each set as ``<cache_dir>/<key>.npz``.
    Returns one dict a set: its ``keep`` arrays stacked, and
    ``poses``."""
    cache_dir = Path(cache_dir)
    paths = [cache_dir / f"{s.key}.npz" for s in sets]
    todo = [i for i, p in enumerate(paths) if not p.exists()]
    if todo:
        jobs = [(f, s.poses[f], s.intrinsics, s.calib, s.width, s.height,
                 s.scene, s.gray, s.keep)
                for s in (sets[i] for i in todo)
                for f in range(len(s.poses))]
        # a pool pays off for KITTI-size frames
        px = sum(j[4] * j[5] for j in jobs)
        workers = min(len(jobs), os.cpu_count() or 1) \
            if px > 2 ** 22 else 1
        if workers == 1:
            out = [_render_one(j) for j in jobs]
        else:
            with ProcessPoolExecutor(
                    workers, mp_context=mp.get_context("spawn")) as ex:
                out = list(ex.map(_render_one, jobs))
        cache_dir.mkdir(parents=True, exist_ok=True)
        for i in todo:
            s = sets[i]
            part, out = out[:len(s.poses)], out[len(s.poses):]
            frames = {k: np.stack([o[k] for o in part]) for k in part[0]}
            frames["poses"] = np.asarray(s.poses, np.float32)
            tmp = paths[i].with_name(f"{paths[i].stem}.{os.getpid()}.tmp.npz")
            np.savez(tmp, **frames)
            os.replace(tmp, paths[i])
    result = []
    for path in paths:
        with np.load(path) as z:
            result.append(dict(z))
    return result


# ---------------------------------------------------------------------------
# the profiler's summary by stage
# ---------------------------------------------------------------------------

STAGE_PREFIXES = ("fused_step.", "fused_dyn.", "fused_eval.", "render.")
#: ``profile_frames``' range around the profiled frames and their drain
WINDOW = "profile.window"


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s0, s1 in sorted(intervals):
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    return busy


def summarize_trace(events, n: int, need_kernels: bool = True) -> dict:
    """From a chrome trace of ``n`` frames in a ``profile.window`` range:
    per stage (the ``fused_step.*`` and ``fused_dyn.*`` ranges; the
    dynamic step's ``fused_dyn.static`` holds the static step's allocate,
    integrate, raycast and decay ranges) [host ms, device kernel ms,
    kernel launches, memsets] a frame, the device's busy time and the
    window's wall time (us; the idle share is 1 - busy / window, as
    ``benchmark/trace.py`` takes it) and the kernel and memset counts (the
    raycast's bitmap and header clears are memsets). Raises when
    ``need_kernels`` and no kernel ran."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    events = [e for e in events if w0 <= e.get("ts", w0 - 1) < w1]
    device = [(e["ts"], min(e["ts"] + e["dur"], w1)) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sorted((e["ts"], e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    memsets = sorted(e["ts"] for e in events if e.get("cat") == "gpu_memset")
    if need_kernels and not kernels:
        raise AssertionError("the profiler recorded no kernel")
    stages = {}
    for e in events:
        name = e.get("name", "")
        if not name.startswith(STAGE_PREFIXES):
            continue
        st = stages.setdefault(name, [0.0, 0.0, 0.0, 0.0])
        if e.get("cat") == "user_annotation":
            st[0] += e["dur"] / 1e3 / n
        elif e.get("cat") == "gpu_user_annotation":
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            inside = [d for t, d in kernels if t0 <= t < t1]
            st[1] += sum(inside) / 1e3 / n
            st[2] += len(inside) / n
            st[3] += sum(t0 <= t < t1 for t in memsets) / n
    return dict(stages=stages, busy=_busy_us(device), window=w1 - w0,
                kernels=len(kernels), memsets=len(memsets))


def profile_frames(run_frames, n: int, out_dir: Path, tag: str = "profile",
                   name: str = "profile_trace.json",
                   cuda: bool = True) -> dict:
    """torch.profiler over ``run_frames()``, which runs ``n`` frames (on
    the card unless ``cuda`` is False: then host ranges only); prints
    ``summarize_trace``'s table and writes the chrome trace to
    ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run_frames()
            if cuda:
                torch.cuda.synchronize()
    trace = out_dir / name
    prof.export_chrome_trace(str(trace))
    summary = summarize_trace(json.loads(trace.read_text())["traceEvents"],
                              n, need_kernels=cuda)
    for stage, (host, dev, launches, sets) in sorted(
            summary["stages"].items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}] {stage:22s} host {host:8.2f} ms, device kernels "
              f"{dev:7.2f} ms, {launches:6.0f} launches and {sets:3.0f} "
              "memsets a frame", flush=True)
    busy, window = summary["busy"], summary["window"]
    if cuda:
        print(f"[{tag}] {n} frames under torch.profiler: device busy "
              f"{busy / 1e3:.2f} of {window / 1e3:.2f} ms (idle share "
              f"{1.0 - busy / window:.3f}), {summary['kernels'] / n:.0f} "
              f"launches and {summary['memsets'] / n:.0f} memsets a frame; "
              f"trace in {trace}", flush=True)
    return summary
