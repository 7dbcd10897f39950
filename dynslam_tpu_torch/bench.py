"""End-to-end bench of the port on KITTI-sized frames (1242x375), on one
CUDA device: ``bench.py``'s function in PyTorch's idiom.

    python -m dynslam_tpu_torch.bench                  # all four modes
    python -m dynslam_tpu_torch.bench --static [--eval]
    python -m dynslam_tpu_torch.bench --dynamic [--eval] [--lag1] [--k4] \\
        [--verbose]
    python -m dynslam_tpu_torch.bench --cpu ...        # plain versions

The bench scenes are KITTI-layout sequences (PNG stereo pairs, calib,
LIDAR scans, MNC mask dumps) rendered once into ``dynslam_tpu_torch/
_build/`` (``scripts/bench_setup.py::ensure_seq``), and the pipelines come
from the builder the CLI uses (``pipeline/builder.py::build_fused``):

- static: stereo depth, sparse scene flow and RANSAC VO, TSDF allocate
  and fuse (K1), the full-frame raycast (K2), voxel decay;
- dynamic (the reference's default mode) at the shipped instance
  configuration (8 object volumes, 16 mask slots): the same on the cut
  view, plus the MNC dump parse, the selection and packing of the mask
  bit-planes and their upload on a one-frame-ahead worker thread (the
  reference's std::async read, DynSlam.cpp:33-45), object RANSAC, the
  silhouette cuts and the pooled object fusion;
- eval-on variants also run the in-loop LIDAR evaluation
  (``FusedEvaluation``; DynSlam.cpp:154-161) and write its CSVs.

Frames are preloaded on the device as float32 gray and a uint8 expand of
it to RGB, with fresh +-1 noise a run. The clock starts when frame
``WARMUP`` has drained and stops when the last frame has: FPS is
``(N_FRAMES - WARMUP - 1) / (t_end - t_steady)``. The static mode waits
on a CUDA event of the previous frame after each frame (one frame in
flight, bench.py's one-frame-deep fetch); the dynamic step's own packed
fetch is its sync.

With no mode flag it renders both sequences and builds the kernels and
the native readers, then runs static, dynamic, dynamic eval-on and static
eval-on, each in a subprocess with a timeout, printing each mode's JSON
line as it ends and the static line again last; it writes
``BENCH_TORCH_DYNAMIC.json`` and ``BENCH_TORCH_EVAL.json`` into ``--out``
(default: ``dynslam_tpu_torch/_build/bench/``) and exits 1 if a mode
failed. Each line:
``{"metric", "value": fps, "unit": "fps", "vs_baseline": fps / 2.5, ...,
"device", "power_limit_w"}``; ``vs_baseline`` is against the reference's
~2.5 Hz (ICRA'18).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dynslam_tpu_torch.device import DeviceLike, resolve_device, upload
from dynslam_tpu_torch.scripts import bench_setup as bs

ROOT = Path(__file__).resolve().parent.parent
#: where the orchestrator writes its artifacts unless told otherwise
OUT_DIR = bs.BUILD_DIR / "bench"
N_FRAMES = bs.N_FRAMES
WARMUP = 3
#: a mode's time limit in the orchestrator
MODE_TIMEOUT = 45 * 60
#: the command a mode runs as (flags appended)
CHILD_CMD = [sys.executable, "-m", "dynslam_tpu_torch.bench"]
#: flags the orchestrator passes on to every mode
PASSTHRU = ("--lag1", "--k4", "--verbose", "--cpu")
METRICS = {
    ("static", False): "end_to_end_fps_kitti_1242x375",
    ("static", True): "end_to_end_fps_static_eval_kitti_1242x375",
    ("dynamic", False): "end_to_end_fps_dynamic_kitti_1242x375",
    ("dynamic", True): "end_to_end_fps_dynamic_eval_kitti_1242x375",
}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def device_fields(device: torch.device) -> dict:
    """The card's name and power limit (W, from nvidia-smi; None where it
    cannot be read), written beside every number."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    power = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True).stdout
        power = float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": power}


def preload_device(left_np, right_np, device):
    """Each frame on the device: float32 gray (left, right) and the left
    gray's uint8 expand to RGB (bench.py:148-157), so ``process_frame``'s
    copies stay on the device."""
    left = [torch.from_numpy(x).to(device, torch.float32) for x in left_np]
    right = [torch.from_numpy(x).to(device, torch.float32) for x in right_np]
    rgb = [torch.from_numpy(x).to(device)[..., None].expand(*x.shape, 3)
           for x in left_np]
    return left, right, rgb


def drain(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def count_csv_rows(csv_dir: str, suffix: str) -> int:
    """Data rows of the first CSV in ``csv_dir`` whose name ends with
    ``suffix``."""
    files = glob.glob(os.path.join(csv_dir, f"*{suffix}"))
    if not files:
        return 0
    with open(files[0]) as f:
        return max(0, sum(1 for _ in f) - 1)


def _launches() -> dict:
    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops import raycast as K2

    return dict(integrate=K1.integrate.launches,
                candidates=K2.candidate_bits.launches,
                raycast=K2.raycast.launches)


def _report(device, res: dict, eval_on: bool, csv_dir: str) -> dict:
    """The kernels' launches and peak memory (stderr), the CSV rows and
    the device fields (the result line)."""
    log(f"kernel launches: {json.dumps(_launches())}")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        log(f"peak device memory {peak:.2f} GB")
    if eval_on:
        rows = count_csv_rows(csv_dir, "unified-depth-result.csv")
        log(f"eval CSV rows written during the run: {rows}")
        res["eval_csv_rows"] = rows
    res.update(device_fields(device))
    return res


def main_static(eval_on: bool = False, device: DeviceLike = None, *,
                root: Optional[str] = None, config=None,
                n_frames: int = N_FRAMES, seed=None,
                csv_dir: Optional[str] = None) -> dict:
    """The static mode (bench.py ``main_static``): ``n_frames`` of the
    static bench sequence (or ``root`` at ``config``); returns its result
    line."""
    from dynslam_tpu_torch.pipeline import builder

    dev = resolve_device(device)
    root = root or bs.ensure_seq(dynamic=False, n_frames=n_frames)
    cfg = config or bs.bench_config(dynamic=False)
    csv_dir = csv_dir or str(bs.BUILD_DIR / "bench_csv_static")
    shutil.rmtree(csv_dir, ignore_errors=True)
    pipe, _, _ = builder.build_fused(root, cfg, with_evaluation=eval_on,
                                     csv_out_dir=csv_dir, device=dev)
    log(f"device {dev}; eval={'ON' if eval_on else 'off'}")
    left_np, right_np = bs.load_frames(root, n_frames, seed=seed)
    left, right, rgb = preload_device(left_np, right_np, dev)

    vox = []  # device scalars, fetched after the window
    prev = None
    t_steady = None
    for i in range(n_frames):
        t0 = time.perf_counter()
        pipe.process_frame(left[i], right[i], rgb[i])
        o = pipe.last_outputs
        if eval_on and pipe.evaluation is not None and o is not None:
            # main.run_fused's submit (EvaluateFrame, DynSlam.cpp:154-161)
            pipe.evaluation.submit(i, o.raycast.depth, o.depth_m, None,
                                   o.used_blocks, o.decayed_blocks)
        if i > WARMUP:
            vox.append((o.fused_voxels, o.march_samples))
        if i > 0 and dev.type == "cuda":
            # one frame in flight: wait for frame i-1, then mark frame i
            if prev is not None:
                prev.synchronize()
            prev = torch.cuda.Event()
            prev.record()
        if i == WARMUP:
            drain(dev)
            t_steady = time.perf_counter()
        log(f"frame {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    drain(dev)
    fps = (n_frames - WARMUP - 1) / (time.perf_counter() - t_steady)
    if eval_on and pipe.evaluation is not None:
        pipe.evaluation.close()
    used = pipe.get_used_block_count()
    # TSDF fusion + raycast voxel throughput, measured on the device: the
    # voxels of the blocks gated into fusion and the samples K2 marched
    vox_per_frame = float(np.mean([int(a) + int(b) for a, b in vox]))
    log(f"{vox_per_frame * fps / 1e6:.0f} M voxel-ops/s (measured "
        f"fusion+raycast, {vox_per_frame / 1e6:.1f} M/frame; "
        f"{vox_per_frame:.1f} a frame)")
    log(f"steady-state: {fps:.2f} FPS over {n_frames - WARMUP - 1} frames; "
        f"map {used} blocks")
    res = {"metric": METRICS["static", eval_on], "value": round(fps, 3),
           "unit": "fps", "vs_baseline": round(fps / 2.5, 3)}
    return _report(dev, res, eval_on, csv_dir)


def main_dynamic(eval_on: bool = False, device: DeviceLike = None, *,
                 lag: int = 2, k4: bool = False, verbose: bool = False,
                 root: Optional[str] = None, config=None,
                 n_frames: int = N_FRAMES, seed=None,
                 csv_dir: Optional[str] = None) -> dict:
    """The dynamic mode (bench.py ``main_dynamic``): ``n_frames`` of the
    dynamic bench sequence (or ``root`` at ``config``) at dispatch lag
    ``lag``, the quarter instance configuration with ``k4``, tracker
    transitions on stderr with ``verbose``; returns its result line."""
    from concurrent.futures import ThreadPoolExecutor

    from dynslam_tpu_torch.pipeline import builder

    dev = resolve_device(device)
    root = root or bs.ensure_seq(dynamic=True, n_frames=n_frames)
    cfg = config or bs.bench_config(dynamic=True, k4=k4)
    csv_dir = csv_dir or str(bs.BUILD_DIR / "bench_csv_dyn")
    shutil.rmtree(csv_dir, ignore_errors=True)
    pipe, _, segp = builder.build_fused(root, cfg, with_evaluation=eval_on,
                                        csv_out_dir=csv_dir, device=dev)
    # lag 2: the device never waits on the packed fetch; tracker decisions
    # go one frame staler (tests/test_torch_fused_dynamic_lag.py)
    pipe.dispatch_lag = lag
    pipe.verbose_tracker = verbose
    log(f"device {dev}; dispatch_lag={lag} K={pipe.K} S={pipe.S} "
        f"eval={'ON' if eval_on else 'off'}")
    left_np, right_np = bs.load_frames(root, n_frames, seed=seed)
    left, right, rgb = preload_device(left_np, right_np, dev)
    h, w = left_np.shape[1:]
    # the provider's host RGB (unused by the dump parse, which follows
    # the provider's frame counter)
    rgb_host = [np.broadcast_to(x[..., None], (h, w, 3)) for x in left_np]

    def seg_job(i):
        """Frame i's segmentation, inside the timed window: the MNC dump
        parse, the K largest, their bit-planes and one upload (pinned
        memory, non-blocking)."""
        dets = segp.segment_frame(rgb_host[i]).instance_detections
        sel = pipe.select_detections(dets, pipe.K)
        db, cb = pipe.pack_mask_bits(sel, h, w, pipe.K)
        both = upload(np.stack([db, cb]), dev)
        return dets, (both[0], both[1])

    t_steady = None
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(seg_job, 0)
        for i in range(n_frames):
            t0 = time.perf_counter()
            dets, masks_dev = fut.result()
            if i + 1 < n_frames:
                fut = pool.submit(seg_job, i + 1)
            # the deferred tracker pass waits on a dispatch's packed
            # outputs: the host stays at most lag frames ahead
            pipe.process_frame(left[i], right[i], rgb[i], dets, masks_dev)
            if i == WARMUP:
                drain(dev)
                t_steady = time.perf_counter()
            log(f"frame {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    # finish the last dispatch: it waits on the whole sequence's chain
    pipe._finish_prev()
    drain(dev)
    fps = (n_frames - WARMUP - 1) / (time.perf_counter() - t_steady)
    # after the clock (bench.py keeps them out of its window too): the
    # last pending fusions and the evaluation's close
    if eval_on:
        pipe.finalize()
        pipe.evaluation.close()
    used = pipe.get_used_block_count()
    vox = getattr(pipe, "last_fused_voxels", 0) \
        + getattr(pipe, "last_march_samples", 0)
    log(f"measured voxel-ops last frame: {vox / 1e6:.1f} M "
        f"(~{vox * fps / 1e6:.0f} M/s)")
    obj_blocks = {t.id: t.reconstruction.get_used_block_count()
                  for t in pipe.tracker.active_tracks.values()
                  if t.has_reconstruction()}
    log(f"steady-state: {fps:.2f} FPS over {n_frames - WARMUP - 1} dynamic "
        f"frames; static map {used} blocks; {len(obj_blocks)} reconstructed "
        f"objects {obj_blocks}")
    res = {"metric": METRICS["dynamic", eval_on], "value": round(fps, 3),
           "unit": "fps", "vs_baseline": round(fps / 2.5, 3),
           "reconstructed_objects": sum(1 for v in obj_blocks.values() if v),
           "instance_config": f"K={pipe.K} S={pipe.S}"}
    return _report(dev, res, eval_on, csv_dir)


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------


def prepare(n_frames: int = N_FRAMES, cpu: bool = False) -> None:
    """Before any mode runs: both bench sequences, rendered in one process
    pool; the kernels (nvcc, unless ``cpu``) and the native readers
    (g++), built together."""
    from concurrent.futures import ThreadPoolExecutor

    from dynslam_tpu_torch.native import build as native_build
    from dynslam_tpu_torch.ops import cuda_build

    todo = [d for d in (False, True) if not os.path.exists(os.path.join(
        bs.seq_root(d, n_frames), ".bench_complete"))]
    if todo:
        t0 = time.perf_counter()
        rendered = bs.render_sets([bs.seq_set(d, n_frames) for d in todo])
        for d, frames in zip(todo, rendered):
            bs.ensure_seq(d, n_frames=n_frames, frames=frames)
        log(f"bench sequences rendered and written in "
            f"{time.perf_counter() - t0:.1f} s")
    sources = [] if cpu else sorted(
        p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(len(sources) + 1) as ex:
        native = ex.submit(native_build.build)
        for name, b in zip(sources, ex.map(cuda_build.build, sources)):
            log(f"kernel {name}: {b.path.name} ({b.seconds:.1f} s)")
        path, seconds = native.result()
    log(f"native readers: {path.name} ({seconds:.1f} s)")


def _run_mode(flags, timeout_s) -> dict:
    """One mode in a subprocess (``CHILD_CMD`` + ``flags``) with a hard
    timeout: its last stdout line as JSON, or an error dict."""
    cmd = list(CHILD_CMD) + list(flags)
    log(f"mode {' '.join(flags)} (timeout {timeout_s} s)")
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=None,
                              timeout=timeout_s, cwd=str(ROOT))
    except subprocess.TimeoutExpired:
        return {"value": None, "error": f"mode timed out after {timeout_s}s"}
    lines = [ln for ln in proc.stdout.decode().splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        return {"value": None, "error": f"mode exited rc={proc.returncode}"}
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        return {"value": None, "error": "mode printed no JSON"}


def _write_json(out_dir: Path, name: str, obj) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / name, "w") as f:
        json.dump(obj, f)
        f.write("\n")


def orchestrate(passthru, out_dir: Path, n_frames: int = N_FRAMES,
                timeout_s: int = MODE_TIMEOUT) -> int:
    """The four modes in turn (bench.py's ``__main__``); 0 if every mode
    gave a value, else 1."""
    cpu = "--cpu" in passthru
    prepare(n_frames, cpu=cpu)
    flags = list(passthru) + (["--frames", str(n_frames)]
                              if n_frames != N_FRAMES else [])
    results = {}
    for mode in (["--static"], ["--dynamic"], ["--dynamic", "--eval"],
                 ["--static", "--eval"]):
        results[" ".join(mode)] = res = _run_mode(mode + flags, timeout_s)
        print(json.dumps(res), flush=True)
    sta, dyn = results["--static"], results["--dynamic"]
    dyn_eval, sta_eval = results["--dynamic --eval"], \
        results["--static --eval"]
    dev = next((r for r in results.values() if "device" in r),
               {"device": None, "power_limit_w": None})
    fields = {k: dev[k] for k in ("device", "power_limit_w")}
    ts = int(time.time())
    if dyn.get("value") is not None:
        _write_json(out_dir, "BENCH_TORCH_DYNAMIC.json", {
            **dyn, "eval_on_fps": dyn_eval.get("value"),
            "eval_csv_rows": dyn_eval.get("eval_csv_rows", 0),
            "static_eval_on_fps": sta_eval.get("value"), "host_ts": ts})
    else:
        # never leave an older artifact that reads as this run's
        prev = None
        try:
            with open(out_dir / "BENCH_TORCH_DYNAMIC.json") as f:
                prev = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
        _write_json(out_dir, "BENCH_TORCH_DYNAMIC.json",
                    {**dyn, **fields, "host_ts": ts, "previous": prev})
    _write_json(out_dir, "BENCH_TORCH_EVAL.json", {
        "dynamic_eval_on": dyn_eval, "static_eval_on": sta_eval,
        **fields, "host_ts": ts})
    print(json.dumps(sta), flush=True)
    failed = [m for m, r in results.items() if r.get("value") is None]
    if failed:
        log(f"modes that failed: {failed}")
    return 1 if failed else 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--static", action="store_true",
                      help="run the static mode alone")
    mode.add_argument("--dynamic", action="store_true",
                      help="run the dynamic mode alone")
    ap.add_argument("--eval", action="store_true",
                    help="the mode's eval-on variant")
    ap.add_argument("--lag1", action="store_true",
                    help="dynamic: dispatch lag 1 (fetch before dispatch)")
    ap.add_argument("--k4", action="store_true",
                    help="dynamic: 4 object volumes and 4 mask slots")
    ap.add_argument("--verbose", action="store_true",
                    help="dynamic: log slot resets, reaps and track state "
                         "transitions")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--frames", type=int, default=N_FRAMES,
                    help=f"frames a mode runs (a prefix of the bench "
                         f"sequences; default {N_FRAMES})")
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="where the orchestrator writes its JSON artifacts")
    ap.add_argument("--timeout", type=int, default=MODE_TIMEOUT,
                    help="seconds a mode may take in the orchestrator")
    args = ap.parse_args(argv)
    if args.frames < WARMUP + 2:
        ap.error(f"--frames must be at least {WARMUP + 2}")
    return args


def mode_kwargs(args: argparse.Namespace) -> dict:
    """``main_static`` / ``main_dynamic`` keyword arguments of the flags."""
    kw = dict(eval_on=args.eval, device="cpu" if args.cpu else None,
              n_frames=args.frames)
    if args.dynamic:
        kw.update(lag=1 if args.lag1 else 2, k4=args.k4,
                  verbose=args.verbose)
    return kw


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dynamic:
        print(json.dumps(main_dynamic(**mode_kwargs(args))), flush=True)
        return 0
    if args.static:
        print(json.dumps(main_static(**mode_kwargs(args))), flush=True)
        return 0
    passthru = [f for f in PASSTHRU if getattr(args, f[2:])]
    return orchestrate(passthru, args.out, args.frames, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
