#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port ``dynslam_tpu_torch`` on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one line each (any failure raises, so the script exits non-zero
and never prints its last line):

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the two hand-written kernels ``csrc/integrate.cu`` and
   ``csrc/raycast.cu`` with nvcc (``sm_90a``, ``-fmad=false``);
3. K1: the fusion kernel against its plain PyTorch version
   ``integrate_ref`` on the card, at the bench configuration (1242x375,
   pool 2**17, local window 160x48x160), and both times;
4. K2: the raycast kernel against ``raycast_ref`` on the same map;
5. slice: ``build_fused_static`` at the bench configuration over 8
   synthetic KITTI-size frames, with ``min_decay_age`` lowered to 4 so
   that decay runs. Checks that both kernels ran once per fused frame, VO,
   the trajectory against ground truth, the map and the render, and
   prints the steady-state frame rate and the host syncs per frame;
6. profile: replays the last two frames under torch.profiler and prints,
   per stage of ``fused_step``, host time, device kernel time and
   launches a frame, and the device's idle share;
8. dynamic slice (run before 7 and 9, which check the kernels on its
   inputs): ``build_fused_dynamic`` at bench.py's dynamic configuration
   (K 16 mask slots, S 8 object volumes, 256x512 fusion crops,
   ``min_decay_age`` 4) over 12 frames of the bench's dynamic scene (three
   cars and two recurring oncoming ones), detections from the port's
   ``detections_from_instance_ids`` (score 0.98), then ``finalize`` and
   ``composited_preview`` (K2 renders every object volume). Checks a
   Dynamic track with a volume of > 100 blocks, the drained pending
   buffer, the trajectory, no dropped blocks, the preview's tinted cars
   and both kernels' launch counts; prints the frame rate over frames 5-9, host syncs a
   frame (and one frame's sync census), peak memory, and the per-stage
   profile of frames 10-11;
7. K1's volume axis: ``integrate_many`` (one launch over the routed object
   volumes) against ``integrate_ref`` volume by volume, on the largest
   routed fusion of phase 8, and both times;
9. K2 on one object volume: ``raycast_instance``'s render from the camera
   of the track's last fused frame against ``raycast_ref``, and the median
   |depth - ground truth| on that car's pixels beside that of the frame's
   own stereo depth.

Then it prints the card's name and power limit (nvidia-smi), one JSON
line with each kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``.

The frames of both scenes are rendered with the port's numpy renderer in
one pool of worker processes and cached under ``dynslam_tpu_torch/_build/``.
"""

from __future__ import annotations

import dataclasses
import json
import linecache
import os
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "dynslam_tpu_torch"

W, H = 1242, 375
N_FRAMES = 8
FPS_FRAMES = 5
MIN_DECAY_AGE = 4
SPEED, YAW_RATE, SCENE_ROWS, SEED = 0.8, 0.003, 11, 11
#: frame (0-based) whose host syncs are counted in sync-debug mode; it
#: lies before the frames the frame rate is taken over
CENSUS_FRAME = 2
#: the dynamic slice: frames, the ones its frame rate is taken over, the
#: ones profiled, the bench scene's cars (bench.py ensure_seq)
N_DYN = 12
DYN_FPS_FRAMES = range(5, 10)
DYN_PROFILE_FRAMES = range(10, 12)
DYN_CENSUS_FRAME = 3
N_DYNAMIC, RECURRING = 3, 2
#: the segmentation dump's score, and its size filter (bbox area over 45^2)
DET_SCORE, DET_MIN_PX = 0.98, 45

#: tolerances of the kernel-vs-plain comparisons (same card, -fmad=false)
K1_MIN_EXACT = 0.9999  # packed words bit-exact; the rest within 1 quantum
K2_MIN_HIT_AGREE = 0.999
K2_MAX_MEDIAN_DEPTH = 1e-4  # m


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


# ---------------------------------------------------------------------------
# configuration and frames
# ---------------------------------------------------------------------------


def bench_config():
    """The bench's static configuration (bench.py ``bench_config``), with
    ``min_decay_age`` lowered from 200 to 4 so that decay runs within 8
    frames."""
    from dynslam_tpu_torch.config import (
        DynSlamConfig, Intrinsics, MapParams, SceneParams, StereoCalibration,
        StereoMatcherParams, VisualOdometryParams, VoxelDecayParams,
    )
    return DynSlamConfig(
        frame_width=W, frame_height=H,
        intrinsics=Intrinsics(707.0912, 707.0912, W / 2.0, 183.1104),
        calibration=StereoCalibration(0.537150654273, 707.0912),
        scene=SceneParams(voxel_size_m=0.05, mu_m=0.30),
        map=MapParams(pool_capacity=2 ** 17, local_dims=(160, 48, 160),
                      max_new_blocks_per_frame=8192),
        stereo=StereoMatcherParams(max_disparity=128),
        vo=VisualOdometryParams(),
        decay=VoxelDecayParams(enabled=True, min_decay_age=MIN_DECAY_AGE,
                               max_decay_weight=1),
    )


def _scene(dynamic: bool):
    from dynslam_tpu_torch.io import synthetic as syn

    if dynamic:
        return syn.SyntheticScene.default_scene(
            with_dynamic=True, seed=SEED, n_dynamic=N_DYNAMIC,
            n_rows=SCENE_ROWS, recurring_oncoming=RECURRING)
    return syn.SyntheticScene.default_scene(seed=SEED, n_rows=SCENE_ROWS)


def _render_one(args):
    """One stereo frame of a bench scene: (left u8, right u8, depth, ids of
    the dynamic boxes (0 elsewhere))."""
    import numpy as np

    from dynslam_tpu_torch.io import synthetic as syn

    frame, pose, intr, calib, width, height, dynamic = args
    scene = _scene(dynamic)
    fr = syn.render_stereo_frame(scene, pose, intr, calib, width, height,
                                 frame=frame)
    dyn_ids = [i + 1 for i, b in enumerate(scene.boxes) if b.is_dynamic]
    objid = np.where(np.isin(fr["object_id"], dyn_ids), fr["object_id"], 0)
    return (syn.to_uint8_rgb(fr["left_gray"])[..., 0],
            syn.to_uint8_rgb(fr["right_gray"])[..., 0],
            fr["depth_m"].astype(np.float32), objid.astype(np.int16))


def render_frames(config, sets, cache_dir: Path):
    """The first frames of the bench scenes (seed 11, 11 building rows,
    0.8 m and 0.003 rad a frame; ``sets`` lists (n_frames, dynamic)),
    rendered once in one pool of worker processes and cached. Returns one
    dict of stacked numpy arrays per set."""
    import multiprocessing as mp

    import numpy as np

    from dynslam_tpu_torch.io import synthetic as syn

    w, h = config.frame_width, config.frame_height
    paths, jobs = [], {}
    for n, dynamic in sets:
        key = (f"{w}x{h}-n{n}-s{SEED}-r{SCENE_ROWS}-v{SPEED}-y{YAW_RATE}"
               + (f"-dyn{N_DYNAMIC}-rec{RECURRING}" if dynamic else ""))
        paths.append(cache_dir / f"smoke_frames-{key}.npz")
        if not paths[-1].exists():
            poses = syn.straight_trajectory(n, speed=SPEED,
                                            yaw_rate=YAW_RATE)
            jobs[len(paths) - 1] = (poses, [
                (f, poses[f], config.intrinsics, config.calibration, w, h,
                 dynamic) for f in range(n)])
    if jobs:
        flat = [j for _, js in jobs.values() for j in js]
        workers = max(1, min(len(flat), os.cpu_count() or 1))
        with ProcessPoolExecutor(
                workers, mp_context=mp.get_context("spawn")) as ex:
            out = list(ex.map(_render_one, flat))
        cache_dir.mkdir(parents=True, exist_ok=True)
        for i, (poses, js) in jobs.items():
            part, out = out[:len(js)], out[len(js):]
            frames = dict(left=np.stack([o[0] for o in part]),
                          right=np.stack([o[1] for o in part]),
                          depth=np.stack([o[2] for o in part]),
                          objid=np.stack([o[3] for o in part]),
                          poses=poses.astype(np.float32))
            tmp = paths[i].with_name(f"{paths[i].stem}.{os.getpid()}.tmp.npz")
            np.savez(tmp, **frames)
            os.replace(tmp, paths[i])
    result = []
    for path in paths:
        with np.load(path) as z:
            result.append(dict(z))
    return result


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases 3 and 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def map_scene(cfg, frames, device):
    """A map at the main path's shapes: frame 0 allocated and fused (plain
    version) from its ground-truth pose and depth, then frame 1 allocated
    and its visible blocks listed. Returns the state and frame 1's view."""
    import torch

    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.ops.integrate import integrate_ref
    from dynslam_tpu_torch.utils.se3 import inverse

    state = tsdf.create_state(cfg, device)
    for f in (0, 1):
        c2w = torch.tensor(frames["poses"][f], device=device)
        w2c = inverse(c2w)
        depth = torch.tensor(frames["depth"][f], device=device)
        gray = torch.tensor(frames["left"][f], device=device)
        rgb = gray[..., None].expand(*gray.shape, 3).contiguous()
        origin = tsdf.compute_origin(cfg, c2w)
        grid = tsdf.build_local_grid(cfg, state, origin)
        state, grid, _ = tsdf.allocate(cfg, state, grid, origin, depth, c2w, f)
        slots, mask = tsdf.visible_blocks(cfg, state, grid, origin, w2c)
        if f == 0:
            integrate_ref(cfg, state, slots, mask, rgb, depth, w2c, f)
    return dict(state=state, grid=grid, origin=origin, slots=slots,
                mask=mask, rgb=rgb, depth=depth, w2c=w2c, c2w=c2w, frame=1)


def check_integrate(cfg, scene, reps: int = 20) -> dict:
    """K1 against ``integrate_ref`` on the same inputs."""
    import torch

    from dynslam_tpu_torch.ops import integrate as K1

    s = scene
    args = (s["slots"], s["mask"], s["rgb"], s["depth"], s["w2c"], s["frame"])
    ref = K1.integrate_ref(cfg, s["state"].clone(), *args)
    got = K1.integrate(cfg, s["state"].clone(), *args)
    torch.cuda.synchronize()
    rows = s["slots"][s["mask"]].long()
    a, b = ref.tsdf_w[rows], got.tsdf_w[rows]
    exact = (a == b).double().mean().item()
    ds = ((a >> 16) - (b >> 16)).abs().max().item()
    dw = ((a & 0xFFFF) - (b & 0xFFFF)).abs().max().item()
    ca, cb = ref.color[rows], got.color[rows]
    dc = max(((ca >> k & 0xFF) - (cb >> k & 0xFF)).abs().max().item()
             for k in (16, 8, 0))
    observed = ((b & 0xFFFF) > 0).double().mean().item()
    if exact < K1_MIN_EXACT or ds > 1 or dw > 1 or dc > 1:
        raise AssertionError(
            f"K1 disagrees with integrate_ref: exact {exact:.6f} (need "
            f">= {K1_MIN_EXACT}), max |dsdf| {ds}, |dw| {dw}, |dcolor| {dc}")
    for k in ("last_seen", "valid", "block_coords", "alloc_frame"):
        if not torch.equal(getattr(ref, k), getattr(got, k)):
            raise AssertionError(f"K1: {k} differs from integrate_ref")
    if observed < 0.2:
        raise AssertionError(f"K1: only {observed:.3f} of voxels observed")

    work = s["state"].clone()
    ms = median_ms(lambda: K1.integrate(cfg, work, *args), reps)
    plain_ms = median_ms(lambda: K1.integrate_ref(cfg, work, *args), reps)
    n_vis = int(s["mask"].sum())
    return dict(exact=exact, max_abs_err=ds / 32767.0, dw=dw, dcolor=dc,
                observed=observed, blocks=n_vis, ms=ms, plain_ms=plain_ms)


def check_raycast(cfg, scene, kernel_reps: int = 20,
                  plain_reps: int = 3) -> dict:
    """K2 against ``raycast_ref`` on the map after K1 fused frame 1."""
    import torch

    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops import raycast as K2

    s = scene
    state = K1.integrate(cfg, s["state"].clone(), s["slots"], s["mask"],
                         s["rgb"], s["depth"], s["w2c"], s["frame"])
    intr = torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy],
                        device=state.device)
    flag = K2.candidate_flags(cfg, state, s["slots"], s["mask"], s["w2c"])
    rargs = (cfg, state, s["grid"], s["origin"], flag, s["c2w"], intr)
    got = K2._raycast_cuda(*rargs)
    ref = K2.raycast_ref(*rargs)
    torch.cuda.synchronize()
    agree = (got.hit == ref.hit).double().mean().item()
    both = got.hit & ref.hit
    dd = (got.depth - ref.depth).abs()[both]
    med = dd.median().item() if dd.numel() else float("inf")
    hit = got.hit.double().mean().item()
    if agree < K2_MIN_HIT_AGREE or med > K2_MAX_MEDIAN_DEPTH or hit < 0.3:
        raise AssertionError(
            f"K2 disagrees with raycast_ref: hit agreement {agree:.5f} (need"
            f" >= {K2_MIN_HIT_AGREE}), median |ddepth| {med:.3g} m (need <= "
            f"{K2_MAX_MEDIAN_DEPTH}), kernel hit fraction {hit:.3f}")
    gt = s["depth"]
    gt_ok = both & (gt > cfg.min_depth) & (gt < cfg.max_depth)
    gt_err = (got.depth - gt).abs()[gt_ok].median().item()
    ms = median_ms(lambda: K2._raycast_cuda(*rargs), kernel_reps)
    plain_ms = median_ms(lambda: K2.raycast_ref(*rargs), plain_reps)
    return dict(agree=agree, median=med, max_abs_err=dd.max().item(),
                hit=hit, gt_err=gt_err,
                samples=int(got.march_samples), ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------------------
# phase 5: the slice
# ---------------------------------------------------------------------------


def count_syncs(fn):
    """Run ``fn`` with CUDA sync-debug warnings on; returns the Counter
    of the synchronising call sites (file:line and source)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter()
    for w in caught:
        line = linecache.getline(w.filename, w.lineno).strip()
        # switching the mode back is reported too: not the frame's
        if "synchroniz" in str(w.message) \
                and "set_sync_debug_mode" not in line:
            path = Path(w.filename)
            try:
                path = path.resolve().relative_to(ROOT)
            except ValueError:
                pass
            sites[f"{path}:{w.lineno} `{line}`"] += 1
    return sites


def run_slice(config, frames, device, census_frame=CENSUS_FRAME) -> dict:
    """Drive ``build_fused_static`` over the frames; the kernels' launch
    counts are set to 0 just before and read just after."""
    import numpy as np
    import torch

    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops import raycast as K2
    from dynslam_tpu_torch.pipeline.builder import build_fused_static

    pipe = build_fused_static(config, config.calibration, device=device,
                              seed=SEED)
    n = frames["left"].shape[0]
    lgs = [torch.tensor(x, dtype=torch.float32, device=device)
           for x in frames["left"]]
    rgs = [torch.tensor(x, dtype=torch.float32, device=device)
           for x in frames["right"]]
    rgbs = [torch.tensor(x, device=device)[..., None].expand(
        *x.shape, 3).contiguous() for x in frames["left"]]
    poses_gt = frames["poses"].astype(np.float64)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    K1.integrate.launches = 0
    K2.raycast.launches = 0
    recs, census = [], Counter()
    for i in range(n):
        t0 = time.perf_counter()
        if i == census_frame and device.type == "cuda":
            census = count_syncs(
                lambda: pipe.process_frame(lgs[i], rgs[i], rgbs[i]))
        else:
            pipe.process_frame(lgs[i], rgs[i], rgbs[i])
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        o = pipe.last_outputs
        if i == 0:
            say("slice", f"frame 0: bootstrap {dt * 1e3:.1f} ms")
            continue
        c2w = np.linalg.inv(pipe.get_pose().astype(np.float64))
        err = float(np.linalg.norm(c2w[:3, 3] - poses_gt[i][:3, 3]))
        rc = o.raycast
        rec = dict(
            ms=dt * 1e3, vo=bool(o.vo_success), inliers=int(o.vo_inliers),
            new=int(o.n_new_blocks), used=int(o.used_blocks),
            freed=int(o.n_freed_blocks), decay=o.decay_ran,
            hit=float(rc.hit.double().mean()), syncs=o.host_syncs,
            err=err, finite=bool(torch.isfinite(rc.depth).all()
                                 and torch.isfinite(o.pose_w2c).all()),
        )
        recs.append(rec)
        say("slice", f"frame {i}: {rec['ms']:.1f} ms, vo {rec['vo']} "
                     f"({rec['inliers']} inliers), new {rec['new']}, used "
                     f"{rec['used']}, freed {rec['freed']}, decay "
                     f"{rec['decay']}, hit {rec['hit']:.3f}, pose err "
                     f"{err * 100:.2f} cm, branch syncs {rec['syncs']}")
    launches = dict(integrate=K1.integrate.launches,
                    raycast=K2.raycast.launches)
    return dict(pipe=pipe, recs=recs, launches=launches, census=census,
                peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if device.type == "cuda" else 0.0),
                frames=(lgs, rgs, rgbs))


def check_slice(res, n_frames: int, config) -> dict:
    recs = res["recs"]
    fused = n_frames - 1
    for k, v in res["launches"].items():
        if v != fused:
            raise AssertionError(f"{k}: {v} launches in the slice, expected "
                                 f"one per fused frame ({fused})")
    vo_ok = sum(r["vo"] for r in recs)
    if vo_ok < fused - 1:
        raise AssertionError(f"VO succeeded on {vo_ok} of {fused} steps")
    travelled = SPEED * fused
    if not recs[-1]["err"] <= 0.02 * travelled:
        raise AssertionError(f"final pose error {recs[-1]['err']:.3f} m > 2% "
                             f"of {travelled:.1f} m")
    if not all(r["finite"] for r in recs):
        raise AssertionError("non-finite pose or raycast depth")
    if recs[-1]["used"] <= 3000:
        raise AssertionError(f"only {recs[-1]['used']} blocks in the map")
    if recs[-1]["hit"] <= 0.5:
        raise AssertionError(f"raycast hit fraction {recs[-1]['hit']:.3f}")
    if not any(r["decay"] for r in recs):
        raise AssertionError("decay never ran")
    tail = recs[-FPS_FRAMES:]
    fps = len(tail) / (sum(r["ms"] for r in tail) / 1e3)
    return dict(vo_ok=vo_ok, fused=fused, travelled=travelled, fps=fps,
                ms=[r["ms"] for r in tail])


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s0, s1 in sorted(intervals):
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    return busy


STAGE_PREFIXES = ("fused_step.", "fused_dyn.")


def summarize_trace(events, n: int) -> dict:
    """From a chrome trace of ``n`` frames: per stage (the
    ``fused_step.*`` and ``fused_dyn.*`` ranges; the dynamic step's
    ``fused_dyn.static`` holds the static step's allocate, integrate,
    raycast and decay ranges) [host ms, device kernel ms, launches] a
    frame, the device's busy and spanned time (us) and the kernel count."""
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sorted((e["ts"], e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("the profiler recorded no kernel")
    stages = {}
    for e in events:
        name = e.get("name", "")
        if not name.startswith(STAGE_PREFIXES):
            continue
        st = stages.setdefault(name, [0.0, 0.0, 0.0])
        if e.get("cat") == "user_annotation":
            st[0] += e["dur"] / 1e3 / n
        elif e.get("cat") == "gpu_user_annotation":
            inside = [d for t, d in kernels
                      if e["ts"] <= t < e["ts"] + e["dur"]]
            st[1] += sum(inside) / 1e3 / n
            st[2] += len(inside) / n
    span = max(t1 for _, t1 in device) - min(t0 for t0, _ in device)
    return dict(stages=stages, busy=_busy_us(device), span=span,
                kernels=len(kernels))


def profile_frames(run_frames, n: int, out_dir: Path, tag: str = "profile",
                   name: str = "profile_trace.json") -> dict:
    """torch.profiler over ``run_frames()``, which runs ``n`` frames;
    prints ``summarize_trace``'s table and writes the chrome trace to
    ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_frames()
        torch.cuda.synchronize()
    trace = out_dir / name
    prof.export_chrome_trace(str(trace))
    summary = summarize_trace(json.loads(trace.read_text())["traceEvents"], n)
    for stage, (host, dev, launches) in sorted(
            summary["stages"].items(), key=lambda kv: -kv[1][0]):
        say(tag, f"{stage:22s} host {host:8.2f} ms, device kernels "
                 f"{dev:7.2f} ms, {launches:6.0f} launches a frame")
    busy, span = summary["busy"], summary["span"]
    say(tag, f"{n} frames under torch.profiler: device busy "
             f"{busy / 1e3:.2f} of {span / 1e3:.2f} ms (idle share "
             f"{1.0 - busy / span:.3f}), {summary['kernels'] / n:.0f} "
             f"kernels a frame; trace in {trace}")
    return summary


# ---------------------------------------------------------------------------
# phases 8, 7 and 9: the dynamic slice and the kernels on its inputs
# ---------------------------------------------------------------------------


def bench_dynamic_config():
    """bench.py ``bench_config(dynamic=True)``: the static configuration
    with the shipped ``InstanceMapParams`` (8 object volumes, 16 mask
    slots, 256x512 fusion crops), ``min_decay_age`` 4 as in phase 5."""
    from dynslam_tpu_torch.config import InstanceMapParams

    return dataclasses.replace(bench_config(), dynamic_mode=True,
                               instance_map=InstanceMapParams())


def frame_detections(objid):
    """A frame's detections the way the segmentation dump gives them:
    ``detections_from_instance_ids`` at score 0.98, bboxes over 45^2 px."""
    from dynslam_tpu_torch.io.segmentation import detections_from_instance_ids

    return [d for d in detections_from_instance_ids(
        objid, min_size_px=DET_MIN_PX, score=DET_SCORE)
        if d.copy_mask.bbox.area > DET_MIN_PX ** 2]


class FusionRecorder:
    """Wraps ``integrate_many`` in the dynamic step: passes every call on
    (the launches count as the main path's) and keeps a copy of the
    inputs of the call over the most volumes, for phase 7."""

    def __init__(self, fn):
        self.fn, self.calls, self.best = fn, 0, None

    def __call__(self, cfg, pool, vols, *args):
        self.calls += bool(len(vols))
        if len(vols) and (self.best is None
                          or len(vols) > len(self.best["vols"])):
            self.best = dict(cfg=cfg, pool=pool.clone(), vols=list(vols),
                             args=[a.clone() if hasattr(a, "clone")
                                   else list(a) for a in args])
        return self.fn(cfg, pool, vols, *args)


def run_dynamic(config, frames, device, out_dir: Path) -> dict:
    """Drive ``build_fused_dynamic`` over the frames (the last ones under
    torch.profiler), then ``finalize``; the kernels' launch counts are set
    to 0 just before and read just after."""
    import numpy as np
    import torch

    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops import raycast as K2
    from dynslam_tpu_torch.pipeline import fused_dynamic
    from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic

    pipe = build_fused_dynamic(config, config.calibration, device=device,
                               seed=SEED)
    n = frames["left"].shape[0]
    lgs = [torch.tensor(x, dtype=torch.float32, device=device)
           for x in frames["left"]]
    rgs = [torch.tensor(x, dtype=torch.float32, device=device)
           for x in frames["right"]]
    rgbs = [torch.tensor(x, device=device)[..., None].expand(
        *x.shape, 3).contiguous() for x in frames["left"]]
    dets = [frame_detections(o) for o in frames["objid"]]
    recorder = FusionRecorder(fused_dynamic.integrate_many)
    fused_dynamic.integrate_many = recorder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K1.integrate.launches = 0
    K2.raycast.launches = 0
    times, syncs, census = {}, {}, Counter()

    def frame(i):
        pipe.process_frame(lgs[i], rgs[i], rgbs[i], dets[i])

    try:
        for i in range(DYN_PROFILE_FRAMES.start):
            t0 = time.perf_counter()
            if i == DYN_CENSUS_FRAME:
                census = count_syncs(lambda: frame(i))
            else:
                frame(i)
            torch.cuda.synchronize()
            times[i] = (time.perf_counter() - t0) * 1e3
            syncs[i] = pipe.last_host_syncs if i else 0
            tracks = {t.id: t.state.value[0]
                      for t in pipe.tracker.active_tracks.values()}
            say("dyn", f"frame {i}: {times[i]:.1f} ms, {len(dets[i])} "
                       f"detections, tracks {tracks}, host syncs "
                       f"{syncs[i]}")
        profile = profile_frames(
            lambda: [frame(i) for i in DYN_PROFILE_FRAMES],
            len(DYN_PROFILE_FRAMES), out_dir, tag="dyn-profile",
            name="profile_trace_dynamic.json")
        pipe.finalize()
        # the GUI's view: the static render with every object volume
        # rendered (K2 on the instance configuration) and tinted in
        rendered = sum(1 for t in pipe.tracker.active_tracks.values()
                       if t.has_reconstruction() and t.frames)
        preview = pipe.composited_preview()
        torch.cuda.synchronize()
    finally:
        fused_dynamic.integrate_many = recorder.fn
    launches = dict(integrate=K1.integrate.launches,
                    raycast=K2.raycast.launches)
    poses_gt = frames["poses"].astype(np.float64)
    # pose_history[k + 1] is frame k's pose (index 0 the identity prior)
    errs = [float(np.linalg.norm(
        np.linalg.inv(pipe.pose_history[k + 1].astype(np.float64))[:3, 3]
        - poses_gt[k][:3, 3])) for k in range(n)]
    return dict(pipe=pipe, times=times, syncs=syncs, census=census,
                launches=launches, recorder=recorder, errs=errs,
                dispatches=pipe.current_frame_no - 1, profile=profile,
                preview=preview, rendered=rendered,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def check_dynamic(res, frames) -> dict:
    from dynslam_tpu_torch.instances.track import TrackState

    pipe = res["pipe"]
    n = frames["left"].shape[0]
    disp = res["dispatches"]
    want = dict(raycast=disp + res["rendered"],
                integrate=disp + res["recorder"].calls)
    if res["launches"] != want:
        raise AssertionError(f"dynamic slice launches {res['launches']}, "
                             f"expected {want} ({disp} dispatches, "
                             f"{res['recorder'].calls} with routed volumes, "
                             f"{res['rendered']} object renders)")
    if res["recorder"].calls == 0:
        raise AssertionError("no object volume was fused")
    recon = [(t, t.reconstruction.get_used_block_count())
             for t in pipe.tracker.active_tracks.values()
             if t.has_reconstruction()]
    dyn = [(t, b) for t, b in recon if t.state == TrackState.DYNAMIC]
    if not dyn or max(b for _, b in dyn) <= 100:
        raise AssertionError(f"no Dynamic track with a volume of > 100 "
                             f"blocks: {[(t, b) for t, b in recon]}")
    if (pipe.carry.pending_depth > 0).any() \
            or (pipe.carry.prev_pending_depth > 0).any():
        raise AssertionError("pending crops left after finalize")
    travelled = SPEED * (n - 1)
    if not res["errs"][n - 1] <= 0.02 * travelled:
        raise AssertionError(f"final pose error {res['errs'][n - 1]:.3f} m "
                             f"> 2% of {travelled:.1f} m")
    if pipe.get_dropped_allocation_count() != 0:
        raise AssertionError(f"{pipe.get_dropped_allocation_count()} blocks "
                             f"dropped")
    preview = res["preview"]
    static = pipe.last_outputs.raycast.color.cpu().numpy()
    tinted = int((preview != static).any(-1).sum())
    if preview.shape != static.shape or preview.dtype != static.dtype \
            or res["rendered"] < len(dyn) or tinted < 100:
        raise AssertionError(
            f"composited_preview: {preview.shape} {preview.dtype}, "
            f"{res['rendered']} object renders, {tinted} pixels tinted")
    ms = [res["times"][i] for i in DYN_FPS_FRAMES]
    return dict(fps=len(ms) / (sum(ms) / 1e3), ms=ms, travelled=travelled,
                recon=recon, tinted=tinted,
                track=max(dyn, key=lambda tb: tb[1])[0])


def check_integrate_many(rec, reps: int = 20, plain_reps: int = 5) -> dict:
    """K1's volume axis (one launch over the recorded call's volumes)
    against ``integrate_ref`` volume by volume, on the same inputs."""
    import torch

    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops.tsdf import pool_slot

    icfg, vols = rec["cfg"], rec["vols"]
    slots, masks, rgb, depth, w2c, frames, intr4 = rec["args"]

    def plain(pool):
        for i, s in enumerate(vols):
            K1.integrate_ref(icfg, pool_slot(pool, s), slots[i], masks[i],
                             rgb[i], depth[i], w2c[i], frames[i], intr4[i])

    def kernel(pool):
        K1.integrate_many(icfg, pool, vols, slots, masks, rgb, depth, w2c,
                          frames, intr4)

    ref, got = rec["pool"].clone(), rec["pool"].clone()
    plain(ref)
    kernel(got)
    torch.cuda.synchronize()
    exact, ds, dw, dc, blocks = [], 0, 0, 0, []
    for i, s in enumerate(vols):
        rows = slots[i][masks[i]].long()
        blocks.append(int(rows.numel()))
        a, b = ref.tsdf_w[s][rows], got.tsdf_w[s][rows]
        exact.append((a == b).double().mean().item())
        ds = max(ds, ((a >> 16) - (b >> 16)).abs().max().item())
        dw = max(dw, ((a & 0xFFFF) - (b & 0xFFFF)).abs().max().item())
        ca, cb = ref.color[s][rows], got.color[s][rows]
        dc = max(dc, max(((ca >> k & 0xFF) - (cb >> k & 0xFF)).abs().max()
                         .item() for k in (16, 8, 0)))
    if min(exact) < K1_MIN_EXACT or ds > 1 or dw > 1 or dc > 1:
        raise AssertionError(
            f"K1 volume axis disagrees with integrate_ref: exact {exact} "
            f"(need >= {K1_MIN_EXACT}), max |dsdf| {ds}, |dw| {dw}, "
            f"|dcolor| {dc}")
    for k in ("last_seen", "valid", "block_coords", "alloc_frame"):
        if not torch.equal(getattr(ref, k), getattr(got, k)):
            raise AssertionError(f"K1 volume axis: {k} differs")
    work = rec["pool"].clone()
    ms = median_ms(lambda: kernel(work), reps)
    plain_ms = median_ms(lambda: plain(work), plain_reps)
    return dict(vols=vols, blocks=blocks, exact=min(exact),
                max_abs_err=ds / 32767.0, dw=dw, dcolor=dc, ms=ms,
                plain_ms=plain_ms)


def check_instance_raycast(pipe, track, frames, kernel_reps: int = 20,
                           plain_reps: int = 3) -> dict:
    """K2 on the track's object volume from the camera of its last fused
    frame (``raycast_instance``'s inputs) against ``raycast_ref``."""
    import numpy as np
    import torch

    from dynslam_tpu_torch.ops import depth as depth_ops
    from dynslam_tpu_torch.ops import raycast as K2
    from dynslam_tpu_torch.ops import stereo as stereo_ops
    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.utils.se3 import inverse

    icfg = pipe.icfg
    k = len(track.frames) - 1
    f = track.frames[k].frame_idx
    state = tsdf.pool_slot(pipe.carry.inst, track.reconstruction.slot)
    c2w = torch.tensor(np.linalg.inv(track.get_frame_pose(k)),
                       dtype=torch.float32, device=pipe.device)
    origin = tsdf.compute_origin(icfg, c2w)
    grid = tsdf.build_local_grid(icfg, state, origin)
    w2c = inverse(c2w)
    slots, mask = tsdf.visible_blocks(icfg, state, grid, origin, w2c)
    flag = K2.candidate_flags(icfg, state, slots, mask, w2c)
    rargs = (icfg, state, grid, origin, flag, c2w, pipe.intr_vec)
    got = K2._raycast_cuda(*rargs)
    ref = K2.raycast_ref(*rargs)
    torch.cuda.synchronize()
    agree = (got.hit == ref.hit).double().mean().item()
    both = got.hit & ref.hit
    dd = (got.depth - ref.depth).abs()[both]
    med = dd.median().item() if dd.numel() else float("inf")
    n_hit = int(got.hit.sum())
    if agree < K2_MIN_HIT_AGREE or med > K2_MAX_MEDIAN_DEPTH or n_hit < 500:
        raise AssertionError(
            f"K2 on an object volume disagrees with raycast_ref: hit "
            f"agreement {agree:.5f} (need >= {K2_MIN_HIT_AGREE}), median "
            f"|ddepth| {med:.3g} m (need <= {K2_MAX_MEDIAN_DEPTH}), "
            f"{n_hit} hits (need >= 500)")
    # the car's pixels in frame f: its object id is the one its copy mask
    # covers most
    objid = frames["objid"][f]
    h, w = objid.shape
    cm = track.frames[k].detection.copy_mask.to_full_frame(h, w)
    car = int(np.bincount(objid[cm & (objid > 0)]).argmax())
    gt = torch.tensor(frames["depth"][f], device=pipe.device)
    on_car = got.hit & torch.tensor(objid == car, device=pipe.device)
    err = (got.depth - gt)[on_car]
    # the stereo depth the volume was fused from, on the same pixels
    lg, rg = (torch.tensor(frames[k][f], dtype=torch.float32,
                           device=pipe.device) for k in ("left", "right"))
    sd = depth_ops.depth_m_from_mm(depth_ops.depth_mm_from_disparity(
        stereo_ops.compute_disparity(lg, rg, pipe.stereo_params), pipe.bf,
        icfg.min_depth, icfg.max_depth))
    s_ok = on_car & (sd > 0)
    stereo_err = (sd - gt)[s_ok]
    ms = median_ms(lambda: K2._raycast_cuda(*rargs), kernel_reps)
    plain_ms = median_ms(lambda: K2.raycast_ref(*rargs), plain_reps)
    return dict(agree=agree, median=med,
                max_abs_err=dd.max().item() if dd.numel() else 0.0,
                hits=n_hit, car_px=int(on_car.sum()),
                gt_err=err.abs().median().item(), gt_bias=err.median().item(),
                stereo_err=stereo_err.abs().median().item(),
                stereo_bias=stereo_err.median().item(),
                frame=f, samples=int(got.march_samples), ms=ms,
                plain_ms=plain_ms, track=track.id)


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 1
    if not (PACKAGE / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found; run from a checkout of "
              "the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} "
                  "device(s)")

    from dynslam_tpu_torch.ops import cuda_build
    from dynslam_tpu_torch.pipeline.builder import engine_config_from

    # 2. build
    for name in ("integrate", "raycast"):
        b = cuda_build.build(name)
        regs = [ln.split("ptxas info    : ")[-1] for ln in b.log.splitlines()
                if "registers" in ln]
        say("build", f"{name}: {b.seconds:.2f} s -> {b.path.name}; "
                     f"{'; '.join(regs) or 'cached'}")

    config = bench_config()
    cfg = engine_config_from(config)
    t0 = time.perf_counter()
    frames, dyn_frames = render_frames(
        config, [(N_FRAMES, False), (N_DYN, True)], cuda_build.BUILD_DIR)
    say("frames", f"{N_FRAMES} static and {N_DYN} dynamic frames {W}x{H} "
                  f"(bench scenes, seed {SEED}) in "
                  f"{time.perf_counter() - t0:.1f} s")

    # 3. K1 vs plain
    scene = map_scene(cfg, frames, device)
    k1 = check_integrate(cfg, scene)
    say("K1", f"integrate vs integrate_ref on {k1['blocks']} visible blocks: "
              f"{k1['exact'] * 100:.4f}% words bit-exact (need >= "
              f"{K1_MIN_EXACT * 100:.2f}%), max |dsdf| {k1['max_abs_err']:.3g}"
              f", |dw| {k1['dw']} q, |dcolor| {k1['dcolor']}; kernel "
              f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms (median of "
              "20)")

    # 4. K2 vs plain
    k2 = check_raycast(cfg, scene)
    say("K2", f"raycast vs raycast_ref at {W}x{H}: hit agreement "
              f"{k2['agree'] * 100:.4f}%, median |ddepth| {k2['median']:.3g}"
              f" m, max {k2['max_abs_err']:.3g} m, hit {k2['hit']:.3f}, "
              f"median |depth - gt| {k2['gt_err']:.4f} m, {k2['samples']} "
              f"samples; kernel {k2['ms']:.4f} ms (median of 20), plain "
              f"{k2['plain_ms']:.1f} ms (median of 3)")

    # 5. slice
    say("slice", f"build_fused_static, bench config with min_decay_age "
                 f"{MIN_DECAY_AGE} (bench: 200), the only change; "
                 f"{N_FRAMES} frames")
    res = run_slice(config, frames, device)
    sl = check_slice(res, N_FRAMES, config)
    static_launches = dict(res["launches"])
    last = res["recs"][-1]
    census = res["census"]
    say("slice", f"launches {res['launches']} = fused frames {sl['fused']}; "
                 f"VO ok {sl['vo_ok']}/{sl['fused']}; final pose error "
                 f"{last['err'] * 100:.2f} cm over {sl['travelled']:.1f} m; "
                 f"used blocks {last['used']}, dropped "
                 f"{res['pipe'].get_dropped_allocation_count()}; hit "
                 f"{last['hit']:.3f}; peak memory {res['peak_gb']:.2f} GB")
    say("slice", f"steady state {sl['fps']:.2f} FPS over the last "
                 f"{FPS_FRAMES} frames ({', '.join(f'{m:.1f}' for m in sl['ms'])}"
                 f" ms); branch syncs per frame {last['syncs']}; all host "
                 f"syncs in frame {CENSUS_FRAME}: {sum(census.values())} "
                 f"{dict(census.most_common())}")

    # 6. where the time goes
    lgs, rgs, rgbs = res["frames"]
    profile_frames(lambda: [res["pipe"].process_frame(lgs[j], rgs[j], rgbs[j])
                            for j in range(N_FRAMES - 2, N_FRAMES)],
                   2, cuda_build.BUILD_DIR)
    del res, scene

    # 8. the dynamic slice (its routed fusions feed phase 7)
    dconfig = bench_dynamic_config()
    say("dyn", f"build_fused_dynamic, bench dynamic config (K "
               f"{dconfig.instance_map.max_detections}, S "
               f"{dconfig.instance_map.max_objects}, crop "
               f"{dconfig.instance_map.fusion_crop}) with min_decay_age "
               f"{MIN_DECAY_AGE}; {N_DYN} frames, dispatch_lag 2")
    dres = run_dynamic(dconfig, dyn_frames, device, cuda_build.BUILD_DIR)
    dyn = check_dynamic(dres, dyn_frames)
    pipe = dres["pipe"]
    dcensus = dres["census"]
    say("dyn", f"launches {dres['launches']} over {dres['dispatches']} "
               f"dispatches ({dres['recorder'].calls} fused object volumes,"
               f" {dres['rendered']} object renders in composited_preview, "
               f"{dyn['tinted']} pixels tinted);"
               f" volumes {[(t.id, t.state.value, b) for t, b in dyn['recon']]}"
               f"; oversize masks {pipe.oversize_masks}; final pose error "
               f"{dres['errs'][N_DYN - 1] * 100:.2f} cm over "
               f"{dyn['travelled']:.1f} m; static blocks "
               f"{pipe.get_used_block_count()}, dropped "
               f"{pipe.get_dropped_allocation_count()}; peak memory "
               f"{dres['peak_gb']:.2f} GB")
    say("dyn", f"{dyn['fps']:.2f} FPS over frames {DYN_FPS_FRAMES.start}-"
               f"{DYN_FPS_FRAMES.stop - 1} "
               f"({', '.join(f'{m:.1f}' for m in dyn['ms'])} ms); host syncs "
               f"a frame {[dres['syncs'][i] for i in DYN_FPS_FRAMES]} (branch "
               f"syncs + the packed fetch); all host syncs in frame "
               f"{DYN_CENSUS_FRAME}: {sum(dcensus.values())} "
               f"{dict(dcensus.most_common())}")

    # 7. K1's volume axis vs plain, on phase 8's largest routed fusion
    k1v = check_integrate_many(dres["recorder"].best)
    say("K1-vol", f"integrate_many over {len(k1v['vols'])} object volumes "
                  f"{k1v['vols']} ({k1v['blocks']} visible blocks) vs "
                  f"integrate_ref per volume: {k1v['exact'] * 100:.4f}% "
                  f"words bit-exact (worst volume; need >= "
                  f"{K1_MIN_EXACT * 100:.2f}%), max |dsdf| "
                  f"{k1v['max_abs_err']:.3g}, |dw| {k1v['dw']} q, |dcolor| "
                  f"{k1v['dcolor']}; kernel {k1v['ms']:.4f} ms (median of "
                  f"20), plain {k1v['plain_ms']:.4f} ms (median of 5)")

    # 9. K2 on one object volume vs plain
    k2o = check_instance_raycast(pipe, dyn["track"], dyn_frames)
    say("K2-obj", f"raycast_instance of track {k2o['track']} from its frame "
                  f"{k2o['frame']} camera vs raycast_ref at {W}x{H}: hit "
                  f"agreement {k2o['agree'] * 100:.4f}%, median |ddepth| "
                  f"{k2o['median']:.3g} m, max {k2o['max_abs_err']:.3g} m, "
                  f"{k2o['hits']} hits; on {k2o['car_px']} car pixels median "
                  f"|depth - gt| {k2o['gt_err']:.4f} m (median signed "
                  f"{k2o['gt_bias']:+.4f}), the frame's stereo depth "
                  f"{k2o['stereo_err']:.4f} m ({k2o['stereo_bias']:+.4f}); "
                  f"{k2o['samples']} samples; kernel {k2o['ms']:.4f} ms "
                  f"(median of 20), plain {k2o['plain_ms']:.1f} ms (median "
                  f"of 3)")

    k1_src = dict(route="cuda", source="dynslam_tpu_torch/csrc/integrate.cu",
                  replaces="dynslam_tpu/ops/pallas_integrate.py:536")
    k2_src = dict(route="cuda", source="dynslam_tpu_torch/csrc/raycast.cu",
                  replaces="dynslam_tpu/ops/pallas_raycast.py:600")
    # one entry per kernel and path: the static slice's launches with
    # phases 3-4's times, the dynamic slice's (static map, object volumes
    # and object renders) with phases 7 and 9's
    kernels = [
        dict(name="integrate", **k1_src, launches=static_launches[
            "integrate"], max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"]),
        dict(name="integrate/volume-axis", **k1_src,
             launches=dres["launches"]["integrate"],
             max_abs_err=k1v["max_abs_err"], ms=k1v["ms"],
             plain_ms=k1v["plain_ms"]),
        dict(name="raycast", **k2_src, launches=static_launches["raycast"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"]),
        dict(name="raycast/object-volume", **k2_src,
             launches=dres["launches"]["raycast"],
             max_abs_err=k2o["max_abs_err"], ms=k2o["ms"],
             plain_ms=k2o["plain_ms"]),
    ]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
