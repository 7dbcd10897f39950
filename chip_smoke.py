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
   launches a frame, and the device's idle share.

Then it prints the card's name and power limit (nvidia-smi), one JSON
line with each kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``.

The frames are rendered with the port's numpy renderer in worker
processes and cached under ``dynslam_tpu_torch/_build/``.
"""

from __future__ import annotations

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


def _render_one(args):
    """One stereo frame of the bench scene: (left u8, right u8, depth)."""
    import numpy as np

    from dynslam_tpu_torch.io import synthetic as syn

    frame, pose, intr, calib, width, height = args
    scene = syn.SyntheticScene.default_scene(seed=SEED, n_rows=SCENE_ROWS)
    fr = syn.render_stereo_frame(scene, pose, intr, calib, width, height,
                                 frame=frame)
    return (syn.to_uint8_rgb(fr["left_gray"])[..., 0],
            syn.to_uint8_rgb(fr["right_gray"])[..., 0],
            fr["depth_m"].astype(np.float32))


def render_frames(config, n_frames: int, cache_dir: Path):
    """The bench scene's first ``n_frames`` frames (seed 11, 11 building
    rows, 0.8 m and 0.003 rad a frame), rendered in parallel once and
    cached. Returns a dict of stacked numpy arrays."""
    import numpy as np

    from dynslam_tpu_torch.io import synthetic as syn

    w, h = config.frame_width, config.frame_height
    key = f"{w}x{h}-n{n_frames}-s{SEED}-r{SCENE_ROWS}-v{SPEED}-y{YAW_RATE}"
    path = cache_dir / f"smoke_frames-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return dict(z)
    poses = syn.straight_trajectory(n_frames, speed=SPEED, yaw_rate=YAW_RATE)
    jobs = [(f, poses[f], config.intrinsics, config.calibration, w, h)
            for f in range(n_frames)]
    workers = max(1, min(n_frames, os.cpu_count() or 1))
    import multiprocessing as mp
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) \
            as ex:
        out = list(ex.map(_render_one, jobs))
    frames = dict(left=np.stack([o[0] for o in out]),
                  right=np.stack([o[1] for o in out]),
                  depth=np.stack([o[2] for o in out]),
                  poses=poses.astype(np.float32))
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **frames)
    os.replace(tmp, path)
    return frames


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


def summarize_trace(events, n: int) -> dict:
    """From a chrome trace of ``n`` frames: per stage (the
    ``fused_step.*`` ranges) [host ms, device kernel ms, launches] a frame,
    the device's busy and spanned time (us) and the kernel count."""
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sorted((e["ts"], e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("the profiler recorded no kernel")
    stages = {}
    for e in events:
        name = e.get("name", "")
        if not name.startswith("fused_step."):
            continue
        st = stages.setdefault(name[len("fused_step."):], [0.0, 0.0, 0.0])
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


def profile_frames(pipe, frames, out_dir: Path, n: int = 2) -> dict:
    """torch.profiler over ``n`` more frames (the last ones, replayed);
    prints ``summarize_trace``'s table and writes the chrome trace to
    ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lgs, rgs, rgbs = frames
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for j in range(len(lgs) - n, len(lgs)):
            pipe.process_frame(lgs[j], rgs[j], rgbs[j])
        torch.cuda.synchronize()
    trace = out_dir / "profile_trace.json"
    prof.export_chrome_trace(str(trace))
    summary = summarize_trace(json.loads(trace.read_text())["traceEvents"], n)
    for name, (host, dev, launches) in sorted(
            summary["stages"].items(), key=lambda kv: -kv[1][0]):
        say("profile", f"{name:10s} host {host:8.2f} ms, device kernels "
                       f"{dev:7.2f} ms, {launches:6.0f} launches a frame")
    busy, span = summary["busy"], summary["span"]
    say("profile", f"{n} frames under torch.profiler: device busy "
                   f"{busy / 1e3:.2f} of {span / 1e3:.2f} ms (idle share "
                   f"{1.0 - busy / span:.3f}), {summary['kernels'] / n:.0f} "
                   f"kernels a frame; trace in {trace}")
    return summary


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
    frames = render_frames(config, N_FRAMES, cuda_build.BUILD_DIR)
    say("frames", f"{N_FRAMES} frames {W}x{H} (bench scene, seed {SEED}) in "
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
    profile_frames(res["pipe"], res["frames"], cuda_build.BUILD_DIR)

    kernels = [
        dict(name="integrate", route="cuda",
             source="dynslam_tpu_torch/csrc/integrate.cu",
             replaces="dynslam_tpu/ops/pallas_integrate.py:536",
             launches=res["launches"]["integrate"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"]),
        dict(name="raycast", route="cuda",
             source="dynslam_tpu_torch/csrc/raycast.cu",
             replaces="dynslam_tpu/ops/pallas_raycast.py:600",
             launches=res["launches"]["raycast"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"]),
    ]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
