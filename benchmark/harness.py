"""One run of one cell: set-up, the measured window, the trace, the
correctness check and the result line.

Set-up renders the cell's drive on the card (``scene``), writes the files
the port's builder reads into the cell's cache folder once (calibration,
frame 0, the MNC dumps of the dynamic cells, the LIDAR scans where the
configuration has a ``"lidar"`` rig), builds the pipeline with
``pipeline.builder.build_fused`` (with the port's evaluation where it
has a rig), and runs the warm-up frames, past the decay age, so that
every timed frame decays in steady state.

The window hands the camera's frames (uint8 gray pairs in host memory)
to ``process_frame`` in a closed loop for ``--seconds``, then drains:

- static: one frame in flight (the loop waits for frame i-1's event after
  handing frame i);
- dynamic: a worker thread parses frame i+1's MNC dump, selects and packs
  its masks and uploads them while the loop runs frame i (the reference's
  std::async read, DynSlam.cpp:33-45); the step's own packed fetch is the
  loop's sync; ``_drain`` closes the window (with the evaluation, the
  window's rows are written before it closes).

A CUDA event recorded after each call, timed against one recorded when
the window opened, gives each frame's latency (hand-off to the device's
end of the work the call enqueued) without a sync in the loop.

Where the cell reports ``frame_device_ms``, an untraced run keeps a
CUDA-only profiler on from the window's opening to its close (the device
clock): the card's busy time, the union of its kernels, copies and
memsets, over the window's frames, read after the window.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import random
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark import check, configio, scene
from benchmark import trace as tr
from benchmark.reference import replay

#: the forbidden top-level modules of a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "dynslam_tpu")
#: window frames whose step the reference recomputes, drawn from the seed
#: among the window's first CHECK_SPAN frames
CHECK_FRAMES, CHECK_SPAN = 1, 16
#: window frames a traced run profiles
TRACE_FRAMES = 8
#: the end-to-end metrics the harness takes
END_TO_END = ("fps", "frame_p90_ms", "frame_device_ms", "setup_s")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cell_frames(cell: dict, seconds: float) -> int:
    """Frames of the cell's stream: the warm-up and ``seconds`` at the
    cell's rate cap."""
    return int(cell["warmup_frames"]) + int(math.ceil(seconds
                                                      * cell["cap_hz"]))


def check_frames(cell: dict, seed: int, n: int) -> list:
    """The frames whose step the reference recomputes: frame 1 (the start)
    and CHECK_FRAMES frames drawn from the seed among the window's first
    CHECK_SPAN frames; each one's next frame is in the stream of ``n``, for
    the check of the carry's hand-over."""
    w = int(cell["warmup_frames"])
    rng = random.Random(seed)
    picks = rng.sample(range(w + 1, min(w + 1 + CHECK_SPAN, n - 1)),
                       CHECK_FRAMES)
    return [1] + sorted(picks)


def _key(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()[:16]


def folder_name(cell: dict, n: int) -> str:
    """The name of the cell's folder for a drive of ``n`` poses: the
    drive, the configuration and, where the configuration file has one,
    its ``"lidar"`` object."""
    key = [cell["drive"], cell["config_file"]["config"], n, 1]
    if "lidar" in cell["config_file"]:
        key.append(cell["config_file"]["lidar"])
    return f"{cell['name']}-{_key(key)}"


def dataset(cell: dict, drive: scene.Drive, gray: torch.Tensor, intr,
            baseline: float, cache: Path, device) -> str:
    """The cell's folder in KITTI odometry layout, written once: the
    calibration, frame 0's left image (the builder reads the frame size
    from it), for a dynamic configuration the MNC dumps of every frame of
    the drive's layout and, for a configuration with a ``"lidar"`` rig,
    every frame's scan (``lidar.write``). Returns its path."""
    conf = cell["config_file"]["config"]
    dynamic = bool(conf.get("dynamic_mode", True))
    n = len(drive.poses)
    root = cache / folder_name(cell, n)
    marker = root / ".complete"
    if marker.exists():
        return str(root)
    t0 = time.perf_counter()
    (root / "image_2").mkdir(parents=True, exist_ok=True)
    seg = root / "seg_image_2" / "mnc"
    seg.mkdir(parents=True, exist_ok=True)
    scene.write_calib(str(root / "calib.txt"), intr, baseline)
    scene.write_png_gray(str(root / "image_2" / "000000.png"),
                         gray[0, 0].cpu().numpy())
    if dynamic:
        h, w = gray.shape[2:]
        ids = np.flatnonzero(drive.dynamic)
        n_det = 0
        for a in range(0, n, 8):
            frames = list(range(a, min(a + 8, n)))
            _, objid = scene.left_depth_ids(drive, frames, intr, w, h,
                                            device)
            for f, ids_f in zip(frames, objid):
                n_det += scene.write_dumps(str(seg), f, ids_f, ids)
        log(f"wrote {n_det} MNC detections for {n} frames")
    rig = cell["config_file"].get("lidar")
    if rig is not None:
        from benchmark import lidar

        t = time.perf_counter()
        h, w = gray.shape[2:]
        n_pts, n_bytes = lidar.write(str(root), drive, rig, intr, w, h,
                                     device)
        log(f"wrote {n} LIDAR scans, {n_pts} points ({n_pts / n:.0f} a "
            f"scan), {n_bytes} B, in {time.perf_counter() - t:.1f} s")
    marker.touch()
    log(f"cell folder {root.name} written in "
        f"{time.perf_counter() - t0:.1f} s")
    return str(root)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class GcClock:
    """Collections and seconds of Python's cyclic collector while it is
    registered in ``gc.callbacks``."""

    def __init__(self):
        self.s, self.n, self.n2, self._t = 0.0, 0, 0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
            return
        self.s += time.perf_counter() - self._t
        self.n += 1
        self.n2 += info["generation"] == 2


class Window:
    """Hand-off times and completion events of the window's frames (on the
    CPU, where every call returns done, the host clock at its return)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.dev = dev
        if self.cuda:
            self.start_event = torch.cuda.Event(enable_timing=True)
        self.handed = []  # (host time, event or host time)

    def open(self) -> float:
        if self.cuda:
            self.start_event.record()
        sync(self.dev)
        self.t0 = time.perf_counter()
        return self.t0

    def mark(self, t_hand: float):
        if not self.cuda:
            self.handed.append((t_hand, time.perf_counter()))
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.handed.append((t_hand, ev))
        return ev

    def latencies_ms(self) -> list:
        if not self.cuda:
            return [(done - t) * 1e3 for t, done in self.handed]
        return [(self.start_event.elapsed_time(ev) / 1e3 + self.t0 - t) * 1e3
                for t, ev in self.handed]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: Path = configio.ROOT,
             bench_json: Optional[Path] = None, device: str = "cuda",
             control: bool = False) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``device`` "cpu" runs the port's plain versions (the tests' tiny
    cells). ``control`` adds the control's readings
    (``check.control_gaps``) under ``"control"``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from dynslam_tpu_torch.config import DynSlamConfig
    from dynslam_tpu_torch.device import upload
    from dynslam_tpu_torch.pipeline import builder
    from dynslam_tpu_torch.pipeline import fused as fused_mod
    from dynslam_tpu_torch.pipeline import fused_dynamic as dyn_mod

    cell = configio.load_workload(name, root)
    conf = cell["config_file"]["config"]
    bench = json.loads(Path(bench_json or root.parent / "BENCHMARK.json")
                       .read_text())
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    e2e_names = [m["name"] for m in bench["end_to_end"]
                 if name in m.get("workloads", [name])]
    device_clock = cuda and not trace and "frame_device_ms" in e2e_names
    su = replay.setup(conf)
    c = su.config
    intr = (c.intrinsics.fx, c.intrinsics.fy, c.intrinsics.cx,
            c.intrinsics.cy)
    baseline = c.calibration.baseline_m
    W, H = c.frame_width, c.frame_height
    dynamic = c.dynamic_mode

    n = cell_frames(cell, seconds)
    t0 = time.perf_counter()
    split = {"start_s": t0 - t_start}
    drive = scene.make_drive(cell["drive"], n)
    clean = scene.render(drive, intr, baseline, W, H, dev, n=n)
    # (N, 2, H, W): the camera's frames
    frames = scene.add_noise(clean, seed).cpu().numpy()
    sync(dev)
    t1 = time.perf_counter()
    split["render_s"] = t1 - t0
    log(f"{n} frames of {len(drive.centre)} boxes rendered in "
        f"{t1 - t0:.1f} s")
    folder = dataset(cell, drive, clean, intr, baseline, root / ".cache",
                     dev)
    del clean
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t2 = time.perf_counter()
    split["folder_s"] = t2 - t1

    config = configio.build(DynSlamConfig, conf)
    rig = cell["config_file"].get("lidar")
    csv_dir = None
    eval_kw = {}
    if rig is not None:
        # the port's in-loop evaluation, as the configuration's
        # ``evaluation`` sets it, its CSVs in a folder of this run's own
        csv_dir = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                               f"bench_csv_{os.getpid()}")
        shutil.rmtree(csv_dir, ignore_errors=True)
        eval_kw = dict(with_evaluation=True, csv_out_dir=csv_dir)
    pipe, _, segp = builder.build_fused(folder, config, baseline_m=baseline,
                                        device=dev, seed=seed, **eval_kw)
    sync(dev)
    split["build_s"] = time.perf_counter() - t2
    checks = check_frames(cell, seed, n)
    plugins = cell["plugins"]
    run_info = dict(folder=folder, csv_dir=csv_dir, seed=seed,
                    frames=checks)
    probe = check.StepProbe(
        dyn_mod if dynamic else fused_mod,
        "fused_dynamic_step" if dynamic else "fused_step", checks,
        fallbacks=(lambda: pipe.oversize_masks) if dynamic else None)
    warm = int(cell["warmup_frames"])
    n_trace = TRACE_FRAMES
    trace_from = warm + 3
    k1_calls = []
    win = Window(dev)
    pool = ThreadPoolExecutor(max_workers=1) if dynamic else None

    seg_s = {}  # frame -> the worker's seconds on it

    def seg_job(i):
        """Frame i's segmentation, inside the window: the MNC dump parse,
        the K largest, their bit-planes and one upload."""
        t = time.perf_counter()
        with record_function("bench.seg_worker"):
            dets = segp.segment_frame(None).instance_detections
            sel = pipe.select_detections(dets, pipe.K)
            db, cb = pipe.pack_mask_bits(sel, H, W, pipe.K)
            both = upload(np.stack([db, cb]), dev)
        seg_s[i] = time.perf_counter() - t
        return dets, (both[0], both[1])

    def k1_probe(real):
        """``integrate`` copying its visible blocks' coordinates, mask and
        pose for K1's bound (device copies, no sync)."""
        def wrapped(cfg, state, slots, slots_mask, *a, **kw):
            rows = slots.long().clamp(0, state.block_coords.shape[0] - 1)
            k1_calls.append((state.block_coords.index_select(0, rows),
                             slots_mask.clone(), a[2].clone(),
                             kw.get("intr4")))
            return real(cfg, state, slots, slots_mask, *a, **kw)
        return wrapped

    prof = window_range = clock = None
    real_integrate = fused_mod.integrate
    fut = pool.submit(seg_job, 0) if dynamic else None
    prev = None
    i = 0
    t_open = t_end = setup_s = None
    done = 0
    gc_clock = GcClock()
    # the last frame the check (its hand-over included) and the trace
    # need, run past the window where the window closes first
    last = max([checks[-1] + 1] + ([trace_from + n_trace - 1] if trace
                                   else []))
    t_warm = time.perf_counter()
    with probe, contextlib.ExitStack() as stack:
        captured = {p: stack.enter_context(mod.probe(pipe, checks, run_info))
                    for p, mod in plugins.items()}
        while i < n:
            if i == warm:
                clock_s = 0.0
                if device_clock:
                    # its start (the first loads CUPTI) is the benchmark's
                    # and not the port's set-up
                    sync(dev)
                    t = time.perf_counter()
                    clock = profile(activities=[ProfilerActivity.CUDA])
                    clock.__enter__()
                    clock_s = split["clock_s"] = time.perf_counter() - t
                t_open = win.open()
                setup_s = t_open - t_start - clock_s
                split["warmup_s"] = t_open - t_warm - clock_s
                gc.callbacks.append(gc_clock)
                log(f"set-up {setup_s:.2f} s ("
                    + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                    + f"); window opens at frame {i}")
            if t_end is None and i > warm \
                    and time.perf_counter() - t_open >= seconds:
                # the window closes with a drain
                if dynamic:
                    _drain(pipe, rig is not None)
                sync(dev)
                t_end = time.perf_counter()
                gc.callbacks.remove(gc_clock)
                done = i - warm
                if clock is not None:
                    clock.__exit__(None, None, None)
                if i > last:
                    break
                log(f"frames {i}..{last} run past the window for the "
                    f"check or the trace")
            if t_end is not None and i > last:
                break
            if trace and i == trace_from:
                sync(dev)
                fused_mod.integrate = k1_probe(real_integrate)
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else []))
                prof.__enter__()
                window_range = record_function("bench.window")
                window_range.__enter__()
            if dynamic:
                dets, masks = fut.result()
                if i + 1 < n:
                    fut = pool.submit(seg_job, i + 1)
            t_hand = time.perf_counter()
            with record_function("bench.loop"):
                if dynamic:
                    pipe.process_frame(frames[i, 0], frames[i, 1], None,
                                       dets, masks)
                else:
                    pipe.process_frame(frames[i, 0], frames[i, 1])
            ev = win.mark(t_hand) if i >= warm and t_end is None else None
            if cuda and not dynamic:
                # one frame in flight: wait for frame i-1
                if prev is not None:
                    prev.synchronize()
                prev = ev or _event()
            i += 1
            if window_range is not None and i == trace_from + n_trace:
                sync(dev)
                window_range.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                window_range = None
                fused_mod.integrate = real_integrate
        if dynamic:
            fut.result()
            pool.shutdown(wait=True)
            _drain(pipe, rig is not None)
        sync(dev)
    if t_end is None:
        # the stream ran out before the time: the window closes at its end
        t_end = time.perf_counter()
        gc.callbacks.remove(gc_clock)
        done = i - warm
        if clock is not None:
            clock.__exit__(None, None, None)
    fused_mod.integrate = real_integrate
    lat = win.latencies_ms()
    fps = done / (t_end - t_open)
    # the port's own peak: the check's copies are left out
    peak = probe.port_peak(dev) if cuda else 0
    log(f"window: {done} frames in {t_end - t_open:.3f} s ({fps:.4f} "
        f"frames/s); static map {pipe.get_used_block_count()} blocks; "
        f"port's peak {peak} B, the check's copies {probe.held} B")
    log(f"Python's collector in the window: {gc_clock.n} collections "
        f"({gc_clock.n2} of generation 2) in {gc_clock.s:.3f} s")
    if dynamic:
        log(f"reconstructed objects: {pipe.reconstructed_objects()}")
    if rig is not None:
        evaluation = _close_evaluation(pipe, csv_dir,
                                       range(warm, warm + done))

    metrics, breakdown, device_extra = {}, None, {}
    if not trace:
        e2e = dict(fps=(fps, "frames/s"),
                   frame_p90_ms=(statistics.quantiles(lat, n=10)[-1]
                                 if len(lat) > 1 else lat[0], "ms"),
                   setup_s=(setup_s, "s"))
        if clock is not None:
            t = time.perf_counter()
            busy, ops = tr.device_busy(clock.profiler.kineto_results.events())
            del clock
            e2e["frame_device_ms"] = (busy * 1e3 / done, "ms")
            log(f"device clock: {ops} operations busy {busy:.4f} s over "
                f"{done} frames ({busy * 1e3 / done:.4f} ms a frame), read "
                f"in {time.perf_counter() - t:.1f} s")
        for m in e2e_names:
            if m in e2e:
                value, unit = e2e[m]
                metrics[m] = {"value": value, "unit": unit}
    traced = range(trace_from, trace_from + n_trace)
    collected = tr.collect_metrics(bench, name, pipe, traced, root) \
        if trace else {}
    del pipe, segp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if trace:
        if prof is None:
            raise RuntimeError(f"the window closed before frame "
                               f"{trace_from + n_trace} of the trace")
        events = tr.export_and_read(prof, os.environ.get("TMPDIR", "/tmp"))
        summary = tr.Summary(events, n_trace, extra=dict(
            k1=_k1_bound(k1_calls, su, H, W),
            seg_worker_ms=(sum(seg_s[f] for f in traced) * 1e3 / n_trace
                           if dynamic else None), **collected))
        metrics = tr.read_metrics(bench, name, summary, root)
        breakdown = summary.breakdown()
        device_extra = dict(busy_s=summary.busy_s,
                            window_s=summary.window_s)

    t_ref = time.perf_counter()
    seg = os.path.join(folder, "seg_image_2", "mnc")
    gaps = check.replay_captured(su, probe.captured, frames, seg, seed)
    for fi, g in zip(sorted(probe.captured), gaps):
        g["handover_diff"] = probe.handover_diff(fi)
    gaps, silent = _with_plugins(gaps, probe, plugins, "gaps", captured, su,
                                 run_info, cell["limits"])
    ok, rows = check.judge(gaps, cell["limits"])
    missing = sorted(set(checks) - set(probe.captured))
    if missing:
        ok = False
        log(f"check frames never ran: {missing}")
    if silent:
        ok = False
        log(f"check plug-ins gave no reading (plug-in, frame, reading): "
            f"{silent}")
    unread = sorted(set(cell["limits"]) - {k for k, _, _ in rows})
    if unread:
        log(f"limits with no reading: {unread}")
    log(f"reference: {len(gaps)} steps in "
        f"{time.perf_counter() - t_ref:.1f} s")
    result = {
        "correct": ok, "attempted": done, "failed": done - len(lat),
        "metrics": metrics,
        "device": dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name(dev) if cuda
                       else "cpu", count=1, memory_peak_bytes=peak,
                       **device_extra),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_split"] = split
    if control:
        cgaps = check.control_gaps(su, probe.captured, frames, seg, seed)
        cgaps, _ = _with_plugins(cgaps, probe, plugins, "control_gaps",
                                 captured, su, run_info, cell["limits"])
        result["control"] = {k: v for k, v, _ in
                             check.judge(cgaps, cell["limits"])[1]}
        result["control_by_frame"] = cgaps
        result["gaps_by_frame"] = gaps
    if csv_dir is not None:
        shutil.rmtree(csv_dir, ignore_errors=True)
        result["evaluation"] = evaluation
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k}: {v!r} (limit {lim!r}) "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr, flush=True)
    return result


def _with_plugins(gaps: list, probe: check.StepProbe, plugins: dict,
                  fn: str, captured: dict, su: replay.Setup, run_info: dict,
                  limits: dict) -> tuple:
    """The built-in ``gaps`` (one dict a frame ``probe`` captured) with each
    plug-in's readings that ``limits`` names, from its ``fn`` ("gaps" or
    "control_gaps"), merged in by frame: (gaps, [(plug-in, frame,
    reading)] that a plug-in gave no reading for)."""
    by_frame = dict(zip(sorted(probe.captured), gaps))
    silent = []
    for p, mod in plugins.items():
        names = [r for r in mod.READINGS if r in limits]
        got = getattr(mod, fn)(captured[p], su, run_info)
        silent += [(p, fi, r) for fi, r in check.merge(
            by_frame, got, names, run_info["frames"])]
    return [by_frame[f] for f in sorted(by_frame)], silent


def _drain(pipe, evaluating: bool) -> None:
    """The dynamic pipeline's tail: its last dispatch's tracker pass and,
    with the evaluation, every frame's evaluation submitted and its rows
    written. The pipeline stages one frame's evaluation at a time and
    renders it once a later dispatch has fused that frame's views; a
    tracker pass out of turn would stage another over it, so the staged
    frame, and then the last one, are rendered first, with the volumes as
    they are (as ``finalize`` renders the last)."""
    if evaluating:
        pipe._flush_eval(force=True)
    pipe._finish_prev()
    if evaluating:
        pipe._flush_eval(force=True)
        pipe.evaluation.drain()


def _close_evaluation(pipe, csv_dir: str, window) -> dict:
    """Closes the port's evaluation and logs what it did: scans read,
    depth rows written, the frames of ``window`` without one, failed
    fetches, the object renders and the worker's time a job."""
    import glob

    ev = pipe.evaluation
    ev.close()
    rows = []
    for path in glob.glob(os.path.join(csv_dir,
                                       "*-unified-depth-result.csv")):
        with open(path) as f:
            rows += [int(line.split(",", 1)[0]) for line in f.readlines()[1:]]
    jobs = sorted(ev.job_ms)
    out = dict(scans=len(jobs), depth_rows=len(rows),
               window_frames_without_rows=sorted(set(window) - set(rows)),
               failed_fetches=ev.failed_fetches,
               eval_crop_renders=pipe.eval_crop_renders,
               eval_full_renders=pipe.eval_full_renders,
               job_ms_median=statistics.median(jobs) if jobs else None,
               job_ms_max=jobs[-1] if jobs else None)
    log("evaluation: " + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def _event():
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _k1_bound(calls, su: replay.Setup, h: int, w: int) -> dict:
    """K1's bound (ms) summed over the static map's launches of the traced
    frames."""
    from benchmark import roofline

    total = 0.0
    for coords, mask, w2c, intr4 in calls:
        intr = intr4 if intr4 is not None else torch.tensor(
            [su.cfg.fx, su.cfg.fy, su.cfg.cx, su.cfg.cy], dtype=torch.float32)
        live = coords[mask]
        px = roofline.k1_pixels(live, w2c, intr, su.cfg.voxel_size, h, w)
        total += roofline.integrate_bound_ms(int(live.shape[0]), px,
                                             int(mask.shape[0]))
    return dict(bound_ms=total, launches=len(calls))
