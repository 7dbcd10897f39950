"""Long-sequence soak at full KITTI resolution: the counterpart of
``scripts/soak.py`` (the decay-gate recipe's shape, ``scripts/
decay_exp.sh`` in the reference: ~1100 frames, decay on) on a closed
loop with turns, through the fused pipelines (``build_fused_static``,
``build_fused_dynamic``).

Renders one LOOP lap once (a pool of processes, cached under
``dynslam_tpu_torch/_build/``), replays it lap after lap with fresh +-1
noise on every frame, and runs the whole frame step: stereo -> VO ->
allocate/fuse (K1) -> raycast (K2) -> decay. At the end it holds the
run to the long-run contract the JAX script asserts (the system, like
the reference, has no loop closure: VO drift re-allocates revisited
geometry at shifted positions, so "no new blocks a lap" is not asserted):

  * steady FPS: the last lap's FPS within 25% of the second lap's
  * decay reclaims blocks once ages pass ``min_decay_age``
  * used blocks never exceed the pool; a saturated pool keeps running,
    counting dropped allocations
  * while the pool has headroom, drops stay 0

``--dynamic`` runs the dynamic pipeline on a loop with RECURRING
vehicles (the renderer's frame index is lap-relative, so the cars repeat
their drive every lap): each lap they enter the view, get tracked and
reconstructed, and leave, so every lap exercises associate ->
reconstruct (slot acquire) -> reap-on-gap -> prune (slot release) ->
slot reuse. Its extra assertions:

  * slot conservation: free slots + live reconstructions == S
  * slots cycle: acquired, and (when the track gap is below a lap)
    released back to all free
  * recurring vehicles create new tracks each lap while the active
    tracks stay bounded
  * the static map's blocks and drops gated as in the static soak

Besides the JAX script's flags, ``--min_decay_age`` (JAX: 200) and
``--pool_capacity`` (JAX: 2^17) cut a soak to a short run or a small
host, and ``--path shuttle`` replaces the circle with a lap forward and
back along the corridor: on the circle a lap shorter than ~60 frames
turns more than 6 degrees a frame, past what VO's 100 px flow radius and
the tracker's box overlap follow at 1242x375, and a short lap is what a
short run affords. The shuttle's dynamic lap renders the cars at the
lap's frame index too, so they drive on through the lap and restart with
the next.

    python -m dynslam_tpu_torch.scripts.soak [--frames 1050] [--cpu]
    python -m dynslam_tpu_torch.scripts.soak --dynamic [--frames 1050]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from dynslam_tpu_torch.scripts.bench_setup import (
    BUILD_DIR, RenderSet, render_sets,
)

#: the loop scene's seed and the dynamic loop's cars (soak.py:85-134),
#: and the shuttle's step (m a frame; the JAX loop's is 2 pi 18 / 150)
LOOP_SEED = 23
LOOP_CARS = 3
SHUTTLE_SPEED = 0.75


def loop_trajectory(n: int, radius: float = 18.0) -> np.ndarray:
    """Closed circular loop at a constant yaw rate (always turning: the
    worst case for the local window's anchor): (n, 4, 4) cam-to-world."""
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        th = 2.0 * np.pi * i / n
        c, s = np.cos(th), np.sin(th)
        poses[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[i, :3, 3] = [radius * (1 - np.cos(th)), 0.0, radius * np.sin(th)]
        poses[i, 3, 3] = 1.0
    return poses


def soak_intrinsics(width: int, height: int, dynamic: bool):
    """KITTI's intrinsics and stereo calibration, as the JAX script has
    them: as they are for the static soak, scaled to the size for the
    dynamic one (the two agree at 1242x375)."""
    from dynslam_tpu_torch.config import Intrinsics, StereoCalibration

    if not dynamic:
        return (Intrinsics(707.0912, 707.0912, width / 2.0, 183.1104),
                StereoCalibration(0.537150654273, 707.0912))
    f = 707.0912 * width / 1242.0
    return (Intrinsics(f, f, width / 2.0, 183.1104 * height / 375.0),
            StereoCalibration(0.537150654273, f))


def soak_config(width: int, height: int, dynamic: bool,
                pool_capacity: int = 2 ** 17, min_decay_age: int = 200,
                track_gap: int = 50, min_flow: int = 18, instance_map=None):
    """The soak's configuration (bench.py's maps: voxel 5 cm, window
    160x48x160, decay of weight-1 voxels); the dynamic one with 4 object
    volumes unless ``instance_map`` says otherwise."""
    from dynslam_tpu_torch.config import (
        DynSlamConfig, InstanceMapParams, MapParams, SceneParams,
        StereoMatcherParams, TrackerParams, VisualOdometryParams,
        VoxelDecayParams,
    )

    intr, calib = soak_intrinsics(width, height, dynamic)
    extra = {}
    if dynamic:
        extra = dict(
            instance_map=instance_map or InstanceMapParams(max_objects=4),
            tracker=TrackerParams(inactive_frame_threshold=track_gap,
                                  min_flow_vectors=min_flow))
    return DynSlamConfig(
        frame_width=width, frame_height=height, intrinsics=intr,
        calibration=calib, dynamic_mode=dynamic,
        scene=SceneParams(voxel_size_m=0.05, mu_m=0.30),
        map=MapParams(pool_capacity=pool_capacity,
                      local_dims=(160, 48, 160),
                      max_new_blocks_per_frame=8192),
        stereo=StereoMatcherParams(max_disparity=128),
        vo=VisualOdometryParams(),
        decay=VoxelDecayParams(enabled=True, min_decay_age=min_decay_age,
                               max_decay_weight=1), **extra)


def shuttle_trajectory(n: int, speed: float = SHUTTLE_SPEED) -> np.ndarray:
    """A closed lap of ``n`` (even) frames along the scene's corridor:
    n / 2 steps of ``speed`` forward, then back over the same poses."""
    if n < 4 or n % 2:
        raise ValueError(f"a shuttle lap has an even number >= 4 of "
                         f"frames, not {n}")
    poses = np.tile(np.eye(4), (n // 2 + 1, 1, 1))
    poses[:, 2, 3] = speed * np.arange(n // 2 + 1)
    return np.concatenate([poses, poses[-2:0:-1]])


def loop_set(n_loop: int, width: int, height: int, dynamic: bool,
             path: str = "loop"):
    """(the ``RenderSet`` of one lap's frames, the rendered frame each lap
    frame shows): stereo frames (uint8, the JAX script's ``clip(g *
    255)`` rule) and, for the dynamic scene, the ids of the dynamic boxes,
    rendered at the lap's frame index (the cars restart every lap).
    ``path``: ``loop`` (JAX's circle) or ``shuttle`` (forward and back
    along the corridor)."""
    intr, calib = soak_intrinsics(width, height, dynamic)
    scene = dict(with_dynamic=True, seed=LOOP_SEED, n_dynamic=LOOP_CARS) \
        if dynamic else dict(seed=LOOP_SEED)
    poses = loop_trajectory(n_loop) if path == "loop" \
        else shuttle_trajectory(n_loop)
    # a static scene looks the same from a pose whenever it is passed
    lap_idx = np.arange(n_loop)
    if path == "shuttle" and not dynamic:
        lap_idx = np.minimum(lap_idx, n_loop - lap_idx)
        poses = poses[:n_loop // 2 + 1]
    key = (f"soak_{path}{'_dyn' if dynamic else ''}-{width}x{height}x"
           f"{n_loop}-s{LOOP_SEED}")
    return RenderSet(key, poses, scene, intr, calib, width, height,
                     gray="trunc", keep=("left", "right", "objid")), lap_idx


def lap_frames(frames: dict, lap_idx) -> dict:
    """A rendered loop set's frames in lap order."""
    return {k: frames[k][lap_idx] for k in ("left", "right", "objid")}


def render_loop(n_loop: int, width: int, height: int, dynamic: bool,
                path: str = "loop", cache_dir: Path = BUILD_DIR) -> dict:
    """One lap's frames (``loop_set``), rendered in a pool of processes
    and cached."""
    rs, lap_idx = loop_set(n_loop, width, height, dynamic, path)
    return lap_frames(render_sets([rs], cache_dir)[0], lap_idx)


def _inputs(loop, k: int, rng):
    """Lap frame ``k`` with fresh +-1 noise (the same on both images):
    float32 gray pair and the uint8 colour image."""
    h, w = loop["left"].shape[1:]
    noise = rng.integers(-1, 2, (h, w), dtype=np.int16)
    lg, rg = (np.clip(loop[side][k].astype(np.int16) + noise, 0, 255)
              .astype(np.float32) for side in ("left", "right"))
    rgb = np.broadcast_to(lg.astype(np.uint8)[..., None], (h, w, 3))
    return lg, rg, np.ascontiguousarray(rgb)


def run_static(config, loop: dict, n_frames: int, device=None, seed: int = 0,
               rng=None, log=print) -> dict:
    """``n_frames`` frames of the loop's laps through
    ``build_fused_static``; per lap: FPS, used, visible (fused this
    frame), decayed and dropped blocks, and the frames' host syncs."""
    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.pipeline.builder import build_fused_static

    pipe = build_fused_static(config, config.calibration, device=device,
                              seed=seed)
    rng = rng or np.random.default_rng()
    lap = loop["left"].shape[0]
    laps, syncs = [], 0
    t_lap = time.perf_counter()
    for i in range(n_frames):
        pipe.process_frame(*_inputs(loop, i % lap, rng))
        if pipe.last_outputs is not None:
            syncs += pipe.last_outputs.host_syncs
        if (i + 1) % lap == 0:
            used = pipe.get_used_block_count()
            fps = lap / (time.perf_counter() - t_lap)
            o = pipe.last_outputs
            laps.append(dict(
                lap=i // lap, fps=fps, used=used,
                visible=int(o.fused_voxels) // tsdf.BLOCK3,
                decayed=int(pipe.carry.state.decayed_blocks),
                dropped=pipe.get_dropped_allocation_count(),
                syncs=syncs / lap))
            log(f"[soak] lap {i // lap}: {fps:.2f} FPS, {used} blocks "
                f"({laps[-1]['visible']} visible), {laps[-1]['dropped']} "
                f"dropped, decayed {laps[-1]['decayed']}, host syncs a "
                f"frame {laps[-1]['syncs']:.2f}")
            syncs = 0
            t_lap = time.perf_counter()
    return dict(pipe=pipe, laps=laps)


def _pool_failures(config, laps) -> list:
    """The map's contract: blocks within the pool, no drops while it has
    headroom."""
    pool = config.map.pool_capacity
    used = [s["used"] for s in laps]
    msgs = []
    if used and max(used) > pool:
        msgs.append(f"used blocks exceeded the pool: {max(used)}")
    saturated = any(b >= pool - config.map.max_new_blocks_per_frame
                    for b in used)
    if laps and laps[-1]["dropped"] != 0 and not saturated:
        msgs.append(f"dropped allocations with pool headroom: "
                    f"{laps[-1]['dropped']}")
    if len(laps) >= 3 and laps[-1]["fps"] < 0.75 * laps[1]["fps"]:
        msgs.append(f"FPS decayed {laps[1]['fps']:.2f} -> "
                    f"{laps[-1]['fps']:.2f}")
    return msgs


def check_static(config, res: dict, n_frames: int, lap: int) -> list:
    """The static soak's failures (empty: the contract holds)."""
    laps = res["laps"]
    msgs = _pool_failures(config, laps)
    if n_frames > int(config.decay.min_decay_age) + lap \
            and laps[-1]["decayed"] == 0:
        msgs.append("decay never reclaimed a block")
    return msgs


def run_dynamic(config, loop: dict, n_frames: int, device=None,
                seed: int = 0, rng=None, log=print) -> dict:
    """``n_frames`` frames of the loop's laps through
    ``build_fused_dynamic`` with the lap-invariant ground-truth
    detections (the precomputed-MNC-dump role), then ``finalize``; per
    lap: FPS, static blocks, drops, live objects, active and created
    tracks, free slots and host syncs; the free slots after every
    frame."""
    from dynslam_tpu_torch.io.segmentation import detections_from_instance_ids
    from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic

    pipe = build_fused_dynamic(config, config.calibration, device=device,
                               seed=seed)
    rng = rng or np.random.default_rng()
    lap = loop["left"].shape[0]
    min_px = config.tracker.min_detection_size_px
    dets = [pipe.select_detections(detections_from_instance_ids(
        o, min_size_px=min_px), pipe.K) for o in loop["objid"]]
    log(f"[soak] lap frames with detections: {sum(1 for d in dets if d)}/"
        f"{lap}")
    laps, free_series, syncs = [], [], 0
    t_lap = time.perf_counter()
    for i in range(n_frames):
        k = i % lap
        pipe.process_frame(*_inputs(loop, k, rng), dets[k])
        syncs += pipe.last_host_syncs if i else 0
        free_series.append(len(pipe._free_slots))
        if (i + 1) % lap == 0:
            used = pipe.get_used_block_count()
            fps = lap / (time.perf_counter() - t_lap)
            laps.append(dict(
                lap=i // lap, fps=fps, used=used,
                dropped=pipe.get_dropped_allocation_count(),
                live_objects=len(pipe.reconstructed_objects()),
                active_tracks=len(pipe.tracker.active_tracks),
                tracks_created=pipe.tracker._track_count,
                free_slots=len(pipe._free_slots), syncs=syncs / lap))
            log(f"[soak] lap {i // lap}: {fps:.2f} FPS, {used} blocks, "
                f"{laps[-1]['dropped']} dropped, {laps[-1]['live_objects']} "
                f"live objects, {laps[-1]['active_tracks']} active tracks, "
                f"{laps[-1]['tracks_created']} tracks ever, "
                f"{laps[-1]['free_slots']}/{pipe.S} slots free, host syncs "
                f"a frame {laps[-1]['syncs']:.2f}")
            syncs = 0
            t_lap = time.perf_counter()
    pipe.finalize()
    return dict(pipe=pipe, laps=laps, free_series=free_series)


def check_dynamic(config, res: dict, lap: int) -> list:
    """The dynamic soak's failures (empty: the contract holds)."""
    pipe, laps, free = res["pipe"], res["laps"], res["free_series"]
    S = pipe.S
    msgs = _pool_failures(config, laps)
    live = sum(1 for t in pipe.tracker.active_tracks.values()
               if t.has_reconstruction())
    if len(pipe._free_slots) + live != S:
        msgs.append(f"slot leak: {len(pipe._free_slots)} free + {live} live "
                    f"!= {S}")
    if min(free) >= S:
        msgs.append("no slot was ever acquired (no reconstruction ran)")
    # a track cannot outlive a lap only when the gap is below a lap; with
    # a longer gap a recurring car re-associates to its old track
    full_lifecycle = config.tracker.inactive_frame_threshold < lap
    if full_lifecycle and max(free[len(free) // 2:]) < S:
        msgs.append("slots never fully released (reap-on-gap/prune broken)")
    if len(laps) >= 2:
        if laps[-1]["tracks_created"] <= laps[0]["tracks_created"]:
            msgs.append("no new tracks after lap 0 (vehicles not recurring)")
        first, last = laps[0]["active_tracks"], laps[-1]["active_tracks"]
        per_lap = laps[-1]["tracks_created"] - laps[-2]["tracks_created"]
        if last > first + S:
            msgs.append(f"active tracks grew across laps: {first} -> {last}")
        if full_lifecycle and last > per_lap + S:
            msgs.append(f"active tracks exceed one lap's creations: {last} "
                        f"> {per_lap} + {S}")
    return msgs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1050)
    ap.add_argument("--loop_frames", type=int, default=150)
    ap.add_argument("--width", type=int, default=1242)
    ap.add_argument("--height", type=int, default=375)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of CUDA")
    ap.add_argument("--dynamic", action="store_true",
                    help="run the dynamic-object pipeline soak")
    ap.add_argument("--track_gap", type=int, default=50,
                    help="tracker inactive-frame threshold (reference "
                         "default 50; lower only for tiny smoke laps)")
    ap.add_argument("--min_flow", type=int, default=18,
                    help="min masked flow vectors for object motion "
                         "(reference default 18; lower only for tiny "
                         "smoke resolutions)")
    ap.add_argument("--min_decay_age", type=int, default=200,
                    help="decay age in frames (the decay-gate recipe's "
                         "200; lower for short runs)")
    ap.add_argument("--pool_capacity", type=int, default=2 ** 17,
                    help="static map pool in blocks (2^17 at 1242x375)")
    ap.add_argument("--path", choices=("loop", "shuttle"), default="loop",
                    help="the lap: the JAX script's circle of radius 18 m, "
                         "or forward and back along the corridor (short "
                         "laps whose frames VO and the tracker follow)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    config = soak_config(args.width, args.height, args.dynamic,
                         args.pool_capacity, args.min_decay_age,
                         args.track_gap, args.min_flow)
    t0 = time.perf_counter()
    loop = render_loop(args.loop_frames, args.width, args.height,
                       args.dynamic, args.path)
    print(f"[soak] {args.loop_frames} loop frames {args.width}x"
          f"{args.height} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    if args.dynamic:
        res = run_dynamic(config, loop, args.frames, device, log=log)
        msgs = check_dynamic(config, res, args.loop_frames)
    else:
        res = run_static(config, loop, args.frames, device, log=log)
        msgs = check_static(config, res, args.frames, args.loop_frames)
    print(json.dumps({
        "metric": "soak_frames_dynamic" if args.dynamic else "soak_frames",
        "frames": args.frames, "laps": res["laps"], "ok": not msgs,
        "failures": msgs}))
    return 0 if not msgs else 1


if __name__ == "__main__":
    sys.exit(main())
