"""Set-up shared by the port's scripts and ``chip_smoke.py``: the part of
``bench.py`` the scripts import (``ensure_seq``, ``load_frames``,
``bench_config``, ``bench.py:69-146``), the bench scenes rendered in one
pool of worker processes and cached under ``dynslam_tpu_torch/_build/``,
and the profiler's summary by stage. It is not a bench: it has no timing
modes and prints no JSON.
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
    """``SyntheticScene.default_scene`` arguments of a bench scene."""
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
        DynSlamConfig, InstanceMapParams, Intrinsics, MapParams,
        SceneParams, StereoCalibration, StereoMatcherParams,
        VisualOdometryParams, VoxelDecayParams,
    )

    imp = InstanceMapParams()
    if k4:
        imp = InstanceMapParams(max_objects=4, max_detections=4)
    return DynSlamConfig(
        frame_width=W, frame_height=H,
        intrinsics=Intrinsics(707.0912, 707.0912, W / 2.0, 183.1104),
        calibration=StereoCalibration(0.537150654273, 707.0912),
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


def ensure_seq(dynamic: bool, root: Optional[str] = None,
               n_frames: int = N_FRAMES) -> str:
    """The bench scene as a KITTI-layout sequence with LIDAR scans and
    MNC dumps (the inputs the reference's own loop reads), written once
    under ``_build/`` (or ``root``) and kept."""
    from dynslam_tpu_torch.config import Intrinsics, StereoCalibration
    from dynslam_tpu_torch.io.synthetic import write_kitti_sequence

    root = root or str(BUILD_DIR / (
        f"bench_seq_{'dyn' if dynamic else 'static'}_{W}x{H}x{n_frames}"))
    marker = os.path.join(root, ".bench_complete")
    if os.path.exists(marker):
        return root
    shutil.rmtree(root, ignore_errors=True)
    print(f"[bench_setup] rendering the {'dynamic' if dynamic else 'static'}"
          f" bench sequence into {root} (once, ~20 s a frame)",
          file=sys.stderr)
    write_kitti_sequence(
        root, num_frames=n_frames, width=W, height=H,
        intrinsics=Intrinsics(707.0912, 707.0912, W / 2.0, 183.1104),
        calib=StereoCalibration(0.537150654273, 707.0912),
        with_dynamic=dynamic, n_dynamic=N_DYNAMIC, write_velodyne=True,
        write_elas_xml=False, write_dispnet=False, seed=SEED,
        scene_kwargs=dict(n_rows=SCENE_ROWS, recurring_oncoming=RECURRING)
        if dynamic else dict(n_rows=SCENE_ROWS),
        trajectory_kwargs=dict(speed=SPEED, yaw_rate=YAW_RATE))
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
    uint8)``, ``float``: ``clip(g * 255)`` as float32) and the renderer's
    outputs kept."""

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


def _render_one(args):
    """One stereo frame: the ``keep`` entries of (left, right) gray by
    ``rule``, depth, the ids of the scene's dynamic boxes (0 elsewhere)
    and the true disparity."""
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
    return {k: out[k] for k in keep}


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
            frames = {k: np.stack([o[k] for o in part]) for k in s.keep}
            frames["poses"] = np.asarray(s.poses, np.float32)
            tmp = paths[i].with_name(f"{paths[i].stem}.{os.getpid()}.tmp.npz")
            np.savez(tmp, **frames)
            os.replace(tmp, paths[i])
    result = []
    for path in paths:
        with np.load(path) as z:
            result.append(dict(z))
    return result


def bench_sets(config, sets) -> list:
    """The ``RenderSet``s of the first frames of the bench scenes (``sets``
    lists (n_frames, dynamic)) at ``config``'s size and intrinsics, on
    the bench's straight trajectory."""
    from dynslam_tpu_torch.io import synthetic as syn

    w, h = config.frame_width, config.frame_height
    return [RenderSet(
        f"smoke_frames-{w}x{h}-n{n}-s{SEED}-r{SCENE_ROWS}-v{SPEED}-y"
        f"{YAW_RATE}" + (f"-dyn{N_DYNAMIC}-rec{RECURRING}" if dynamic
                         else ""),
        syn.straight_trajectory(n, speed=SPEED, yaw_rate=YAW_RATE),
        bench_scene(dynamic), config.intrinsics, config.calibration, w, h)
        for n, dynamic in sets]


# ---------------------------------------------------------------------------
# the profiler's summary by stage
# ---------------------------------------------------------------------------

STAGE_PREFIXES = ("fused_step.", "fused_dyn.", "fused_eval.", "render.")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s0, s1 in sorted(intervals):
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    return busy


def summarize_trace(events, n: int, need_kernels: bool = True) -> dict:
    """From a chrome trace of ``n`` frames: per stage (the
    ``fused_step.*`` and ``fused_dyn.*`` ranges; the dynamic step's
    ``fused_dyn.static`` holds the static step's allocate, integrate,
    raycast and decay ranges) [host ms, device kernel ms, kernel launches,
    memsets] a frame, the device's busy and spanned time (us) and the
    kernel and memset counts (the raycast's bitmap and header clears are
    memsets). Raises when ``need_kernels`` and no kernel ran."""
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
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
    span = (max(t1 for _, t1 in device) - min(t0 for t0, _ in device)
            if device else 0.0)
    return dict(stages=stages, busy=_busy_us(device), span=span,
                kernels=len(kernels), memsets=len(memsets))


def profile_frames(run_frames, n: int, out_dir: Path, tag: str = "profile",
                   name: str = "profile_trace.json",
                   cuda: bool = True) -> dict:
    """torch.profiler over ``run_frames()``, which runs ``n`` frames (on
    the card unless ``cuda`` is False: then host ranges only); prints
    ``summarize_trace``'s table and writes the chrome trace to
    ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
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
    busy, span = summary["busy"], summary["span"]
    if span:
        print(f"[{tag}] {n} frames under torch.profiler: device busy "
              f"{busy / 1e3:.2f} of {span / 1e3:.2f} ms (idle share "
              f"{1.0 - busy / span:.3f}), {summary['kernels'] / n:.0f} "
              f"launches and {summary['memsets'] / n:.0f} memsets a frame; "
              f"trace in {trace}", flush=True)
    return summary
