#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port ``dynslam_tpu_torch`` on one GPU.

Run from the repository root::

    python3 chip_smoke.py                      # as a check: no arguments
    python3 chip_smoke.py --parent DIR         # and time DIR's kernels too

``--parent`` takes a checkout of an earlier commit (at least its
``dynslam_tpu_torch/csrc/``): its kernels are built beside these and
timed on the same inputs, in turns (parent, kernel, kernel, parent). A
parent library with this tree's C ABI (``cuda_build.ABI_VERSION``) is
called with the same arguments; one with ABI 1 (up to 7c3c753) through
the argument lists of that ABI; any other ABI raises.

Phases, one line each (any failure raises, so the script exits non-zero
and never prints its last line):

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels ``csrc/integrate.cu`` and
   ``csrc/raycast.cu`` with nvcc (``sm_90a``, ``-fmad=false``), one nvcc
   process per source, all started together; prints registers and spills;
3. K1: the fusion kernel against its plain PyTorch version
   ``integrate_ref`` on the card, at the bench configuration (1242x375,
   pool 2**17, local window 160x48x160);
4. K2: the candidate pre-pass against ``candidate_bits_ref`` (the bitmap
   must be equal bit for bit), then the march kernel against
   ``raycast_ref`` on the same map;
5. slice: ``build_fused_static`` at the bench configuration over 8
   synthetic KITTI-size frames, with ``min_decay_age`` lowered to 4 so
   that decay runs. Checks that every kernel ran once per fused frame, VO,
   the trajectory against ground truth, the map and the render, and
   prints the steady-state frame rate and the host syncs per frame;
6. profile: replays the last two frames under torch.profiler and prints,
   per stage of ``fused_step``, host time, device kernel time, kernel
   launches and memsets a frame, and the device's idle share; fails if
   the raycast stage takes more than 8 launches and memsets a frame;
8. dynamic slice (run before 7 and 9, which check the kernels on its
   inputs): ``build_fused_dynamic`` at bench.py's dynamic configuration
   (K 16 mask slots, S 8 object volumes, 256x512 fusion crops,
   ``min_decay_age`` 4) over 12 frames of the bench's dynamic scene (three
   cars and two recurring oncoming ones), detections from the port's
   ``detections_from_instance_ids`` (score 0.98), then ``finalize`` and
   ``composited_preview`` (K2 renders every object volume). Checks a
   Dynamic track with a volume of > 100 blocks, the drained pending
   buffer, the trajectory, no dropped blocks, the preview's tinted cars
   and the kernels' launch counts; prints the frame rate over frames 5-9,
   host syncs a frame (and one frame's sync census), peak memory, and the
   per-stage profile of frames 10-11;
7. K1's volume axis: ``integrate_many`` (one launch over the routed object
   volumes) against ``integrate_ref`` volume by volume, on the largest
   routed fusion of phase 8;
9. the pre-pass and K2 on one object volume: ``raycast_instance``'s
   render from the camera of the track's last fused frame against
   ``candidate_bits_ref`` and ``raycast_ref``, and the median
   |depth - ground truth| on that car's pixels beside that of the frame's
   own stereo depth.

10. the static slice with evaluation on: phase 5 again (bench.py's static
    configuration) with ``FusedEvaluation`` attached and every frame
    submitted as ``main.run_fused`` does, against LIDAR ground truth
    sampled from the rendered depth (every 2nd pixel, at most 120k points
    a scan, written with ``calib.txt`` under ``dynslam_tpu_torch/_build/``).
    Checks the CSV files under ``base_csv_name``'s names, unified rows for
    frames 1-7 in order, non-zero memory rows, the fused render's correct
    share at the KITTI rule >= 0.9 from frame 2, and that the frame
    thread's host syncs equal phase 5's; prints the frame rate beside phase
    5's, the worker's time a job, one job's launches and the eval's device
    time;
11. the dynamic slice with evaluation on: phase 8 again (dispatch lag 2,
    no profile) with ``FusedEvaluation`` attached, then ``finalize`` and
    ``close``. Checks a dynamic bucket with fused hits, the tracker rows
    (a reconstructed track, no dropped detection), at least one
    crop-viewport render, the launch counts, and that the frame thread's
    host syncs equal phase 8's; prints the frame rate beside phase 8's and
    the crop and full-frame object renders a frame;
12. K2 in the crop viewport: the pre-pass and the march on the inputs of
    the largest object volume's last crop render of phase 11 (principal
    point shifted by the crop origin) against ``candidate_bits_ref`` and
    ``raycast_ref``, also in a viewport 3 rows and 5 columns smaller (8x4
    tiles cut at its edges), with the times of phases 4 and 9.

13. the staged dynamic slice through the port's CLI: phase 8's 12 frames
    written as a KITTI-odometry folder with the port's writers (PNGs, ELAS
    XML depth from the rendered depth, MNC dumps, ``calib.txt``, the
    ground-truth poses, LIDAR as phase 10 writes it), then
    ``dynslam_tpu_torch.main.main`` in this process at ``DynSlamConfig()``
    with ``--min_decay_age 4 --enable_evaluation --evaluation_delay 2
    --dump_previews_every 4``. Checks trajectory rows, drift, a Dynamic
    track with a pooled volume of > 100 blocks, no dropped blocks, the CSV
    files and their rows, a tinted car in a colour preview, K1 launches a frame (1 static + at most 1 pool
    flush, or the catch-up chain of a volume initialised that frame) and
    K2 launches a frame (at most 2 + the renderable tracks);
    prints the frame rate over frames 5-9, the host syncs of frame 6,
    peak memory and the timing report. Then a split run (``--frame_limit
    8 --checkpoint_out --enable_evaluation`` at delay 0, whose static
    bucket's KITTI-rule share must reach 0.9 from frame 2) resumed with
    ``--resume_from`` for frames 8-11, held to tests/test_checkpoint.py's
    criteria against the continuous run;
14. K1 on the pool flush: phase 13's flush over the most volumes (their
    full-frame masked views) against ``integrate_ref`` volume by volume;
15. K2 in the staged roles: the static map from a preview pose off the
    trajectory (3 m up, 6 m back, pitched 15 degrees down) and one pool
    slot at the render pose ``composite_instance_depth_maps`` uses,
    against ``candidate_bits_ref`` and ``raycast_ref``.

16. the CLI's last outputs, on phase 13's folder: (a) phase 13's split
    run again with ``--prefetch``, whose trajectory and CSVs must equal
    the split run's byte for byte (prints both runs' ``1-read-input``
    mean and frame rate); (b) the 12 frames with ``--enable_evaluation
    --dump_previews_every 4 --save_mesh --save_object_meshes
    --direct_refinement``: ``static_map.obj`` parses with valid faces and
    at least ``MIN_STATIC_TRIS`` triangles, an object mesh has triangles,
    the run prints at least one refined object motion, drift <= 2%, the
    LIDAR error overlays of frames 4 and 8 have green splats (prints the
    time direct refinement takes and the green share); (c) ``render_orbit``
    of the static map (8 frames, each with hits; K2's launches and memsets
    a render under torch.profiler) and ``render_chase_sequence``; (d) the
    dense tracer (``MapEngine.get_raycast`` at 621x188) against its run on
    a CPU copy of the map, with its time and launches; (e) ``extract_mesh``
    of (b)'s static map and of phase 8's largest slot equal to its run on
    CPU copies.

17. the learned models and the parallel paths, on the frames of phases 5
    and 8: (a) DispNet-lite (shipped widths, max disparity 128) from a
    seeded Flax-layout param set through ``convert.flax_to_state_dict``,
    its 1242x375 forward on the card against a CPU copy (TF32 off), then
    30 Adam steps at batch 2 against the static frames' disparity ``bf /
    depth``, whose loss must fall below 0.7 of the first; (b) SegNet-lite
    trained 600 steps on the dynamic frames' car masks but the last, the
    learned provider on that held-out frame (a detection overlapping a car
    at IoU > 0.5; the same boxes and >= 99.9% equal masks from a CPU copy)
    and a ``save_params``/``load_params`` round trip; (c) the sharded training
    step at world size 1 over NCCL against the unsharded one, ``entry()``
    and ``dryrun_multichip(1)`` on the card; (d) static and dynamic batch
    evaluation of 4 sequence maps (sequence s is static frames s..s+3; the
    dynamic run adds phase 8's car masks and the shipped object volumes)
    at the bench configuration: finite metrics within JAX's test bounds on
    the last frame, K1 launches a frame (1 static, 2 dynamic), sequence 0
    equal to a one-sequence run, the pools' bytes and sequence-frames a
    second; (e) K1 on the sequence pool: the static run's first
    ``integrate_many`` call against ``integrate_ref`` map by map, with its
    times.

18. the port's last scripts and its native readers: (a) every MNC mask,
    velodyne scan and PNG of phase 13's folder and a ``write_pfm`` file
    read through the staged readers with the native parsers
    (``native/fastio.cpp``, built with g++ in phase 2) and with their
    numpy twins, equal byte for byte; then phase 16a's ``--prefetch``
    split run with the numpy twins and with the native readers in turns
    (numpy, native, native, numpy), outputs byte-identical, printing each
    mode's ``1-read-input``, ``2-segmentation`` and frame total; (b) the
    static soak (``scripts/soak.py``) at the bench's static configuration
    over 3 laps of a 20-frame shuttle (10 frames forward along the
    corridor, 10 back), decay age 10, with the soak's contract (FPS of the
    last lap within 25% of lap 2's, decay reclaims, no drops with
    headroom), then K1, the pre-pass and K2 at the last lap's map against
    their plain versions; (c) the dynamic soak at the same size with the
    shipped ``InstanceMapParams`` and its contract (slot conservation,
    slots acquired, new tracks each lap, active tracks bounded), and K1 on
    its largest routed volume fusion against ``integrate_ref``; (d)
    ``measure_fallback``'s 6 reps of the oversize full-frame fallback
    (``fuse_slot_fullframe``) with its host, upload and run times, and its
    K1 launch against ``integrate_ref``; (e) ``vo_drift`` at its defaults
    (320x96, f 260, 100 frames) held to its targets (|scale drift| <= 0.3
    %/frame, RMSE <= 0.5 m) and ``profile_dynamic`` over phase 8's frames,
    which must see every stage of the dynamic step run.

Phases 3, 4, 7, 9, 12, 14, 15, 17 and 18 also print each kernel's times: the
bare kernel (its prepared C call alone, no Python conversion between
launches), warm (50 back-to-back launches between two CUDA events) and
cold (the L2
flushed by a 128 MB write before each launch, an event pair around each);
the wrapper's time (the whole Python call, as earlier records gave it);
the bound (the bytes of the inputs the function reads, each once, plus
the bytes it writes, over 3.35 TB/s, or operations over 67 TFLOP/s fp32,
whichever is larger; K1 counts the distinct pixels its voxels project
to, the march the distinct pool words a replay of ``raycast_ref``
samples) and the share of it the bare kernel reaches; and the plain
version's time.

Then it prints the card's name and power limit (nvidia-smi), one JSON
line with an entry per kernel and path (launches on the main path and a
frame, error, bare/cold/wrapper/parent times, bound and share), and last
``{"ok": true, "device": {...}}``.

The frames (both bench scenes, the soaks' laps and vo_drift's sequence)
are rendered with the port's numpy renderer in one pool of worker
processes and cached under ``dynslam_tpu_torch/_build/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import linecache
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "dynslam_tpu_torch"
sys.path.insert(0, str(ROOT))

from dynslam_tpu_torch.scripts.bench_setup import (  # noqa: E402
    BUILD_DIR, H, SEED, SPEED, W, bench_config, bench_sets, profile_frames,
    render_sets,
)

N_FRAMES = 8
FPS_FRAMES = 5
#: bench.py's decay age (200) lowered so that decay runs within 8 frames
MIN_DECAY_AGE = 4
#: frame (0-based) whose host syncs are counted in sync-debug mode; it
#: lies before the frames the frame rate is taken over
CENSUS_FRAME = 2
#: the dynamic slice: frames, the ones its frame rate is taken over, the
#: ones profiled, the bench scene's cars (bench.py ensure_seq)
N_DYN = 12
DYN_FPS_FRAMES = range(5, 10)
DYN_PROFILE_FRAMES = range(10, 12)
DYN_CENSUS_FRAME = 3
#: the segmentation dump's score, and its size filter (bbox area over 45^2)
DET_SCORE, DET_MIN_PX = 0.98, 45

#: tolerances of the kernel-vs-plain comparisons (same card, -fmad=false)
K1_MIN_EXACT = 0.9999  # packed words bit-exact; the rest within 1 quantum
K2_MIN_HIT_AGREE = 0.999
K2_MAX_MEDIAN_DEPTH = 1e-4  # m
#: the raycast stage of a static frame: the pre-pass (bitmap clear and
#: kernel) and the march (header clear and kernel), and no small ops
RAYCAST_STAGE_MAX_LAUNCHES = 8
#: kernel sources under dynslam_tpu_torch/csrc/
KERNEL_SOURCES = ("integrate", "raycast")


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


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

#: H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM3 bytes
#: and fp32 operations (outside the tensor cores) a second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: back-to-back launches a bare-kernel time is averaged over, and the size
#: of the buffer written to flush the 50 MB L2 before each cold launch
BARE_LAUNCHES = 50
FLUSH_BYTES = 128 * 2 ** 20
#: operations counted a unit of work, from the rule each kernel computes:
#: K1's update of one voxel (projection, gates, weighted means, packing),
#: one march sample and one pixel's set-up and epilogue, one pre-pass pool
#: word and one block corner
OPS_PER_VOXEL = 64
OPS_PER_SAMPLE = 40
OPS_PER_PIXEL = 40
OPS_PER_WORD = 4
OPS_PER_CORNER = 12


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops import raycast as K2

    K1.integrate.launches = 0
    K2.candidate_bits.launches = 0
    K2.raycast.launches = 0


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops import raycast as K2

    return dict(integrate=K1.integrate.launches,
                candidates=K2.candidate_bits.launches,
                raycast=K2.raycast.launches)


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call: for a wrapper, the whole Python call (its
    conversions, allocations and small ops with the kernel)."""
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


def bare_ms(launch, flush, n: int = BARE_LAUNCHES):
    """A kernel's own time from its prepared C call ``launch`` (a
    ``cuda_build.Launch``: no Python conversion or allocation between
    launches): (warm, cold) ms a launch. Warm: ``n`` back-to-back launches
    between two events, divided by ``n``, after 3 warm-up launches. Cold:
    ``n`` launches, each after a write of ``flush`` (>= 64 MB, which
    evicts the working set from the 50 MB L2), each between its own event
    pair; the mean."""
    import torch

    errs = [launch() for _ in range(3)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        errs.append(launch())
    end.record()
    end.synchronize()
    warm = start.elapsed_time(end) / n
    pairs = []
    for i in range(n):
        flush.fill_(i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        errs.append(launch())
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    if any(errs):
        raise RuntimeError(f"bare launches failed: cudaError {set(errs)}")
    return warm, sum(a.elapsed_time(b) for a, b in pairs) / n


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the fp32 peak (ms)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(n_bytes), bound_ops=int(n_ops))


def k1_pixels(cfg, coords, slots, mask, w2c, intr, h: int, w: int) -> int:
    """The distinct pixels K1 reads in one view: the nearest pixel
    (clamped to the image) of every voxel centre of the live visible
    blocks, projected as ``integrate_ref`` projects it."""
    import torch

    from dynslam_tpu_torch.ops.integrate import _VOX_OFFSETS
    from dynslam_tpu_torch.ops.tsdf import BLOCK, fma, transform_points

    c = coords[slots[mask].long()].to(torch.float32)
    vox = _VOX_OFFSETS.to(device=c.device, dtype=torch.float32)
    pc = transform_points(w2c, (c[:, None, :] * BLOCK + vox[None] + 0.5)
                          * cfg.voxel_size)
    z = torch.clamp(pc[..., 2], min=1e-3)
    u = torch.round(fma(pc[..., 0] / z, intr[0], intr[2])).to(torch.int32)
    v = torch.round(fma(pc[..., 1] / z, intr[1], intr[3])).to(torch.int32)
    px = torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)
    return int(torch.unique(px).numel())


def integrate_bound(blocks, pixels, n_visible: int) -> dict:
    """K1 over volumes with ``blocks`` live visible blocks and ``pixels``
    distinct pixels read (``k1_pixels``) each: every live block's pool
    rows read and written once (tsdf_w and color, 4 x 2 KB), its
    coordinates, slot and last_seen; each pixel's depth (f32) and RGB
    (3 B); every entry's mask byte; each volume's pose, intrinsics and
    frame."""
    n = sum(blocks)
    n_bytes = n * (4 * 512 * 4 + 12 + 4 + 4) + 7 * sum(pixels) \
        + len(blocks) * (n_visible + 84)
    return bound(n_bytes, n * 512 * OPS_PER_VOXEL)


def march_reads(cfg, state, grid, origin, bits, c2w, intr, ref) -> dict:
    """The pool words the march reads, counted distinct: ``raycast_ref``'s
    march (whose outputs and sample count the kernel's equal) replayed
    over a scene that records the flat voxel index of every sample in a
    candidate block (an sdf word; for the hit's colour and weight, also
    the colour word). Each distinct block costs one grid word."""
    import torch

    from dynslam_tpu_torch.ops import raycast as K2

    class Recording(K2._Scene):
        def __init__(self, *args):
            super().__init__(*args)
            self.sdf, self.colour, self.in_cw = [], [], False

        def cand_voxel(self, o, d, t):
            idx = super().cand_voxel(o, d, t)
            read = idx[idx >= 0]
            self.sdf.append(read)
            if self.in_cw:
                self.colour.append(read)
            return idx

        def sample_cw(self, o, d, t):
            self.in_cw = True
            try:
                return super().sample_cw(o, d, t)
            finally:
                self.in_cw = False

    cdims = K2.coarse_dims(cfg)
    coarse = K2.unpack_bits(bits[K2.fine_words(cfg):],
                            cdims[0] * cdims[1] * cdims[2]).view(cdims)
    sc = Recording(cfg, state, grid, origin, K2.unpack_bits(bits, cfg.n_cells),
                   coarse, c2w, intr, K2._march_constants(cfg))
    out = K2._march_ref(cfg, sc, c2w, intr)
    if not torch.equal(out.depth, ref.depth) \
            or int(out.march_samples) != int(ref.march_samples):
        raise AssertionError("the recording replay differs from raycast_ref")
    sdf = torch.unique(torch.cat(sc.sdf))
    return dict(sdf_words=int(sdf.numel()),
                colour_words=int(torch.unique(torch.cat(sc.colour)).numel()),
                blocks=int(torch.unique(sdf >> 9).numel()))


def march_bound(cfg, n_words: int, reads: dict, samples: int) -> dict:
    """The march: its outputs written once (depth, points, colour, weight,
    hit: 24 B a pixel; the 16 B header), the bitmap, the pose, intrinsics
    and origin read once, and the distinct pool words it reads
    (``march_reads``: sdf and colour words, a grid word a block)."""
    n_pix = cfg.height * cfg.width
    n_bytes = (n_pix * 24 + 16 + n_words * 4 + 64 + 16 + 12
               + 4 * (reads["sdf_words"] + reads["colour_words"]
                      + reads["blocks"]))
    return bound(n_bytes, samples * OPS_PER_SAMPLE + n_pix * OPS_PER_PIXEL)


def candidates_bound(n_live: int, n_visible: int, n_words: int) -> dict:
    """The pre-pass: each live visible block's tsdf_w row (2 KB), its
    coordinates, slot and grid word; every entry's mask byte; the pose and
    origin; the bitmap written once."""
    n_bytes = n_live * (512 * 4 + 12 + 4 + 4) + n_visible + 64 + n_words * 4
    return bound(n_bytes, n_live * (512 * OPS_PER_WORD
                                    + 8 * OPS_PER_CORNER))


def kernel_times(launch, flush, parent_launch=None) -> dict:
    """Bare-kernel times of a launch and, when given, of the parent
    commit's kernel on the same inputs: parent, kernel, kernel, parent in
    turns, each (warm, cold) the mean of its two turns."""
    if parent_launch is None:
        warm, cold = bare_ms(launch, flush)
        return dict(kernel_ms=warm, kernel_ms_cold=cold,
                    parent_kernel_ms=None, parent_kernel_ms_cold=None)
    p1 = bare_ms(parent_launch, flush)
    k1 = bare_ms(launch, flush)
    k2 = bare_ms(launch, flush)
    p2 = bare_ms(parent_launch, flush)
    return dict(kernel_ms=(k1[0] + k2[0]) / 2,
                kernel_ms_cold=(k1[1] + k2[1]) / 2,
                parent_kernel_ms=(p1[0] + p2[0]) / 2,
                parent_kernel_ms_cold=(p1[1] + p2[1]) / 2)


def reads_text(reads: dict) -> str:
    """The distinct pool words a march reads (``march_reads``)."""
    return (f"reads {reads['sdf_words']} sdf and {reads['colour_words']} "
            f"colour words of {reads['blocks']} blocks")


def timing_text(r: dict) -> str:
    """One line of a kernel's times, bound and share."""
    parent = "" if r["parent_kernel_ms"] is None else (
        f"; parent kernel {r['parent_kernel_ms']:.4f} ms warm, "
        f"{r['parent_kernel_ms_cold']:.4f} ms cold")
    return (f"bare kernel {r['kernel_ms']:.4f} ms warm, "
            f"{r['kernel_ms_cold']:.4f} ms cold (L2 flushed; means of "
            f"{BARE_LAUNCHES}); wrapper {r['wrapper_ms']:.4f} ms; bound "
            f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
            f"({r['bound_bytes'] / 1e6:.2f} MB, {r['bound_ops'] / 1e6:.1f} "
            f"Mop), share {r['bound_ms'] / r['kernel_ms']:.3f} warm, "
            f"{r['bound_ms'] / r['kernel_ms_cold']:.3f} cold; plain "
            f"{r['plain_ms']:.4f} ms{parent}")


# ---------------------------------------------------------------------------
# the parent commit's kernels, for before/after times in one call
# ---------------------------------------------------------------------------


def parent_launch(parent: dict, lib: str, launch, v1=None):
    """The parent commit's kernel on the inputs of ``launch`` (None without
    ``parent``). Its library's C ABI (``cuda_build.abi_version``) decides
    how: this tree's ABI takes ``launch``'s own arguments through the
    parent's entry of the same name; ABI 1 (the first two slices, up to
    7c3c753) takes the call ``v1()`` builds, None where that ABI has no
    such kernel; any other ABI raises."""
    import ctypes

    from dynslam_tpu_torch.ops import cuda_build

    if not parent:
        return None
    path = parent[lib]
    abi = cuda_build.abi_version(path)
    if abi == cuda_build.ABI_VERSION:
        fn = getattr(ctypes.CDLL(str(path)), launch.fn.__name__)
        fn.argtypes, fn.restype = launch.fn.argtypes, launch.fn.restype
        return launch._replace(fn=fn)
    if abi == 1:
        return v1() if v1 else None
    raise RuntimeError(f"--parent: {path.name} has C ABI {abi}; this script "
                       f"times ABI {cuda_build.ABI_VERSION} and 1")


def parent_integrate(lib, cfg, pool, vols, slots, mask, depth, rgb, w2c,
                     intr, frames):
    """K1's C call in ABI 1 (one CTA per visible entry) on prepared device
    tensors: ``vols`` (n,) and ``frames`` (n,) int32."""
    from dynslam_tpu_torch.ops import cuda_build
    from dynslam_tpu_torch.ops.tsdf import SDF_SCALE, recip32

    import torch

    fn = cuda_build.load(lib, "dynslam_integrate",
                         "pppp i pi ppi ppppp ii fffffffff i p")
    h, w = depth.shape[1:]
    args = (pool.tsdf_w.data_ptr(), pool.color.data_ptr(),
            pool.block_coords.data_ptr(), pool.last_seen.data_ptr(),
            cfg.pool_capacity, vols.data_ptr(), vols.shape[0],
            slots.data_ptr(), mask.data_ptr(), slots.shape[1],
            depth.data_ptr(), rgb.data_ptr(), w2c.data_ptr(),
            intr.data_ptr(), frames.data_ptr(), h, w, cfg.voxel_size,
            cfg.mu, recip32(cfg.mu), cfg.mu * 0.25, recip32(1000.0),
            recip32(SDF_SCALE), cfg.max_weight, cfg.min_depth,
            cfg.max_depth, int(cfg.use_depth_weighting),
            torch.cuda.current_stream().cuda_stream)
    return cuda_build.Launch(fn, args, (pool, vols, slots, mask, depth, rgb,
                                        w2c, intr, frames))


def parent_raycast(lib, cfg, state, grid, origin, flag, c2w, intr):
    """K2's C call in ABI 1 (16x16 CTAs, global flag lookups) on prepared
    device tensors, into outputs of its own."""
    import torch

    from dynslam_tpu_torch.ops import cuda_build
    from dynslam_tpu_torch.ops import raycast as K2
    from dynslam_tpu_torch.ops.tsdf import SDF_SCALE

    fn = cuda_build.load(lib, "dynslam_raycast",
                         "ppppppp iiiiiii ffffffffffffff pppp p")
    m = K2._march_constants(cfg)
    h, w = cfg.height, cfg.width
    dx, dy, dz = cfg.local_dims
    outs = [torch.empty(h, w, dtype=t, device=state.device)
            for t in (torch.float32, torch.int32, torch.float32,
                      torch.int32)]
    args = (state.tsdf_w.data_ptr(), state.color.data_ptr(), grid.data_ptr(),
            flag.data_ptr(), c2w.data_ptr(), intr.data_ptr(),
            origin.data_ptr(), dx, dy, dz, h, w, m.n_steps, m.max_dda,
            m.inv_voxel, m.block, 1.0 / SDF_SCALE, m.dt, 1.5 * m.dt,
            0.25 * m.dt, 0.5 * m.dt, cfg.mu, 0.9 * cfg.mu,
            2.5 * cfg.voxel_size, m.t_min, m.t_max, m.t_cap,
            m.t_cap - 1e-3, *(o.data_ptr() for o in outs),
            torch.cuda.current_stream().cuda_stream)
    return cuda_build.Launch(fn, args, (state, grid, origin, flag, c2w, intr,
                                        outs))


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


def check_integrate(cfg, scene, flush, parent=None, reps: int = 20) -> dict:
    """K1 against ``integrate_ref`` on the same inputs, and its times."""
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
    wrapper_ms = median_ms(lambda: K1.integrate(cfg, work, *args), reps)
    largs, kw = K1.single_view_args(cfg, work, *args)
    launch = K1._launch_args(*largs, **kw)
    _, pool, vols, sl, mk, rgb, depth, w2c, intr, _ = largs

    def v1():
        return parent_integrate(
            parent["integrate"], cfg, pool, vols, sl, mk, depth, rgb, w2c,
            intr, torch.full((1,), s["frame"], dtype=torch.int32,
                             device=work.device))

    times = kernel_times(launch, flush,
                         parent_launch(parent, "integrate", launch, v1))
    plain_ms = median_ms(lambda: K1.integrate_ref(cfg, work, *args), reps)
    n_vis = int(s["mask"].sum())
    pixels = k1_pixels(cfg, work.block_coords, s["slots"], s["mask"],
                       s["w2c"], intr[0], *s["depth"].shape)
    return dict(exact=exact, max_abs_err=ds / 32767.0, dw=dw, dcolor=dc,
                observed=observed, blocks=n_vis, pixels=pixels,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, **times,
                **integrate_bound([n_vis], [pixels], s["slots"].shape[0]))


def check_candidates(cfg, state, grid, origin, slots, mask, c2w, flush,
                     parent=None, reps: int = 20, plain_reps: int = 5
                     ) -> dict:
    """The pre-pass bitmap against ``candidate_bits_ref`` (exactly), and
    its times."""
    import torch

    from dynslam_tpu_torch.ops import raycast as K2

    cargs = (cfg, state, grid, origin, slots, mask, c2w)
    got = K2.candidate_bits(*cargs)
    ref = K2.candidate_bits_ref(*cargs)
    torch.cuda.synchronize()
    n_bits = got.shape[0] * 32
    cg, cr = K2.unpack_bits(got, n_bits), K2.unpack_bits(ref, n_bits)
    n_cand = int(K2.unpack_bits(ref, cfg.n_cells).sum())
    if not torch.equal(got, ref):
        raise AssertionError(
            f"pre-pass bitmap differs from candidate_bits_ref in "
            f"{int((cg != cr).sum())} of {n_bits} bits ({n_cand} candidate "
            f"cells in the plain version)")
    if n_cand == 0:
        raise AssertionError("pre-pass: no candidate cell")
    wrapper_ms = median_ms(lambda: K2.candidate_bits(*cargs), reps)
    launch = K2._candidates_launch(*cargs, torch.empty_like(got))
    times = kernel_times(launch, flush,
                         parent_launch(parent, "raycast", launch))
    plain_ms = median_ms(lambda: K2.candidate_bits_ref(*cargs), plain_reps)
    n_live = int(mask.sum())
    return dict(bits=got, n_cand=n_cand, n_live=n_live, max_abs_err=0.0,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, **times,
                **candidates_bound(n_live, slots.shape[0], got.shape[0]))


def compare_march(got, ref, what: str) -> dict:
    """A march against ``raycast_ref``: hit agreement and median depth
    error at the thresholds, and the in-kernel epilogue (points, colour,
    weight) on the pixels whose depth is bit-equal."""
    import torch

    agree = (got.hit == ref.hit).double().mean().item()
    both = got.hit & ref.hit
    dd = (got.depth - ref.depth).abs()[both]
    med = dd.median().item() if dd.numel() else float("inf")
    same = (got.hit == ref.hit) & (got.depth == ref.depth)
    epi = ((got.points == ref.points).all(-1) & (got.color == ref.color)
           .all(-1) & (got.weight == ref.weight))[same]
    epi_agree = epi.double().mean().item() if epi.numel() else 0.0
    if agree < K2_MIN_HIT_AGREE or med > K2_MAX_MEDIAN_DEPTH \
            or epi_agree < K2_MIN_HIT_AGREE:
        raise AssertionError(
            f"{what} disagrees with raycast_ref: hit agreement {agree:.5f} "
            f"(need >= {K2_MIN_HIT_AGREE}), median |ddepth| {med:.3g} m "
            f"(need <= {K2_MAX_MEDIAN_DEPTH}), points/colour/weight equal "
            f"on {epi_agree:.5f} of the equal-depth pixels (need >= "
            f"{K2_MIN_HIT_AGREE})")
    return dict(agree=agree, median=med, both=both, epi_agree=epi_agree,
                max_abs_err=dd.max().item() if dd.numel() else 0.0,
                samples=int(got.march_samples),
                ref_samples=int(ref.march_samples),
                hits=int(got.hit.sum()))


def march_times(cfg, state, grid, origin, bits, c2w, intr, flush, pre,
                parent, cmp, reps: int, plain_reps: int) -> dict:
    """The march kernel's wrapper, bare, parent and plain times, and its
    bound from the words this render reads."""
    import torch

    from dynslam_tpu_torch.ops import raycast as K2

    rargs = (cfg, state, grid, origin, bits, c2w, intr)
    wrapper_ms = median_ms(lambda: K2._march_cuda(*rargs), reps)
    out, header = K2.empty_raycast(cfg, state.device)
    launch = K2._march_launch(*rargs, out, header)

    def v1():
        flag = K2.candidate_flags(cfg, state, pre["slots"], pre["mask"], c2w)
        return parent_raycast(parent["raycast"], cfg, state, grid,
                              origin.to(torch.int32), flag, c2w, intr)

    times = kernel_times(launch, flush,
                         parent_launch(parent, "raycast", launch, v1))
    plain_ms = median_ms(lambda: K2.raycast_ref(*rargs), plain_reps)
    return dict(wrapper_ms=wrapper_ms, plain_ms=plain_ms, **times,
                **march_bound(cfg, bits.shape[0], cmp["reads"],
                              cmp["samples"]))


def check_raycast(cfg, scene, flush, parent=None, kernel_reps: int = 20,
                  plain_reps: int = 3) -> dict:
    """The pre-pass and K2 against ``candidate_bits_ref`` and
    ``raycast_ref`` on the map after K1 fused frame 1."""
    import torch

    from dynslam_tpu_torch.ops import integrate as K1
    from dynslam_tpu_torch.ops import raycast as K2

    s = scene
    state = K1.integrate(cfg, s["state"].clone(), s["slots"], s["mask"],
                         s["rgb"], s["depth"], s["w2c"], s["frame"])
    intr = torch.tensor([cfg.fx, cfg.fy, cfg.cx, cfg.cy],
                        device=state.device)
    pre = check_candidates(cfg, state, s["grid"], s["origin"], s["slots"],
                           s["mask"], s["c2w"], flush, parent)
    pre.update(slots=s["slots"], mask=s["mask"])
    rargs = (cfg, state, s["grid"], s["origin"], pre["bits"], s["c2w"], intr)
    got = K2._march_cuda(*rargs)
    ref = K2.raycast_ref(*rargs)
    torch.cuda.synchronize()
    cmp = compare_march(got, ref, "K2")
    cmp["reads"] = march_reads(*rargs, ref)
    hit = got.hit.double().mean().item()
    if hit < 0.3:
        raise AssertionError(f"K2: kernel hit fraction {hit:.3f}")
    gt = s["depth"]
    gt_ok = cmp["both"] & (gt > cfg.min_depth) & (gt < cfg.max_depth)
    gt_err = (got.depth - gt).abs()[gt_ok].median().item()
    times = march_times(cfg, state, s["grid"], s["origin"], pre["bits"],
                        s["c2w"], intr, flush, pre, parent, cmp,
                        kernel_reps, plain_reps)
    return dict(cmp, hit=hit, gt_err=gt_err, pre=pre, **times)


# ---------------------------------------------------------------------------
# phase 5: the slice
# ---------------------------------------------------------------------------


def count_syncs(fn):
    """Run ``fn`` with CUDA sync-debug warnings on; returns the Counters
    of the synchronising call sites (file:line and source) of the calling
    (frame) thread and of every other thread (the evaluation's worker).
    Sync-debug mode is process-wide, so each warning is filed by the
    thread that raised it."""
    import threading

    import torch

    caught = []
    frame_thread = threading.get_ident()

    def record(message, category, filename, lineno, file=None, line=None):
        caught.append((threading.get_ident() == frame_thread, message,
                       filename, lineno))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    own, other = Counter(), Counter()
    for on_frame_thread, message, filename, lineno in caught:
        line = linecache.getline(filename, lineno).strip()
        # switching the mode back is reported too: not the frame's
        if "synchroniz" in str(message) \
                and "set_sync_debug_mode" not in line:
            path = Path(filename)
            try:
                path = path.resolve().relative_to(ROOT)
            except ValueError:
                pass
            (own if on_frame_thread else other)[
                f"{path}:{lineno} `{line}`"] += 1
    return own, other


def run_slice(config, frames, device, census_frame=CENSUS_FRAME,
              eval_root: Optional[Path] = None, tag: str = "slice") -> dict:
    """Drive ``build_fused_static`` over the frames, with a
    ``FusedEvaluation`` of ``eval_root`` attached and every frame
    submitted as ``main.run_fused`` does when it is given; the kernels'
    launch counts are set to 0 just before and read just after."""
    import numpy as np
    import torch

    from dynslam_tpu_torch.pipeline.builder import (
        attach_evaluation, build_fused_static,
    )

    pipe = build_fused_static(config, config.calibration, device=device,
                              seed=SEED)
    if eval_root is not None:
        attach_evaluation(pipe, config, str(eval_root),
                          csv_out_dir=str(eval_root / "csv"))
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

    def step(i):
        pipe.process_frame(lgs[i], rgs[i], rgbs[i])
        o = pipe.last_outputs
        if pipe.evaluation is not None and o is not None:
            pipe.evaluation.submit(i, o.raycast.depth, o.depth_m, None,
                                   o.used_blocks, o.decayed_blocks)

    reset_launches()
    recs, census, worker = [], Counter(), Counter()
    for i in range(n):
        t0 = time.perf_counter()
        if i == census_frame and device.type == "cuda":
            census, worker = count_syncs(lambda: step(i))
        else:
            step(i)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        o = pipe.last_outputs
        if i == 0:
            say(tag, f"frame 0: bootstrap {dt * 1e3:.1f} ms")
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
        say(tag, f"frame {i}: {rec['ms']:.1f} ms, vo {rec['vo']} "
                     f"({rec['inliers']} inliers), new {rec['new']}, used "
                     f"{rec['used']}, freed {rec['freed']}, decay "
                     f"{rec['decay']}, hit {rec['hit']:.3f}, pose err "
                     f"{err * 100:.2f} cm, branch syncs {rec['syncs']}")
    launches = launch_counts()
    if pipe.evaluation is not None:
        pipe.evaluation.close()
    return dict(pipe=pipe, recs=recs, launches=launches, census=census,
                worker_census=worker,
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


# ---------------------------------------------------------------------------
# phases 8, 7 and 9: the dynamic slice and the kernels on its inputs
# ---------------------------------------------------------------------------


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


class CropRecorder:
    """Wraps a pipeline's ``render_instance_crop``: passes every call on
    (the launches count as the main path's) and keeps, per pooled slot,
    the viewport of its latest crop-viewport render (pose and crop
    origin), for phase 12."""

    def __init__(self, pipe):
        self.fn, self.last = pipe.render_instance_crop, {}
        pipe.render_instance_crop = self

    def __call__(self, slot, cam_to_world, u0, v0):
        self.last[slot] = dict(c2w=cam_to_world, u0=u0, v0=v0)
        return self.fn(slot, cam_to_world, u0, v0)


def run_dynamic(config, frames, device, out_dir: Path,
                eval_root: Optional[Path] = None,
                census_frames=(DYN_CENSUS_FRAME,), profile: bool = True,
                tag: str = "dyn") -> dict:
    """Drive ``build_fused_dynamic`` over the frames (the last ones under
    torch.profiler unless ``profile`` is False), then ``finalize``, with a
    ``FusedEvaluation`` of ``eval_root`` attached when it is given; the
    kernels' launch counts are set to 0 just before and read just
    after."""
    import numpy as np
    import torch

    from dynslam_tpu_torch.pipeline import fused_dynamic
    from dynslam_tpu_torch.pipeline.builder import (
        attach_evaluation, build_fused_dynamic,
    )

    pipe = build_fused_dynamic(config, config.calibration, device=device,
                               seed=SEED)
    if eval_root is not None:
        attach_evaluation(pipe, config, str(eval_root),
                          csv_out_dir=str(eval_root / "csv"))
    crops = CropRecorder(pipe)
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

    reset_launches()
    times, syncs, censuses = {}, {}, {}

    def frame(i):
        pipe.process_frame(lgs[i], rgs[i], rgbs[i], dets[i])

    try:
        for i in range(DYN_PROFILE_FRAMES.start if profile else n):
            t0 = time.perf_counter()
            if i in census_frames:
                censuses[i] = count_syncs(lambda: frame(i))
            else:
                frame(i)
            torch.cuda.synchronize()
            times[i] = (time.perf_counter() - t0) * 1e3
            syncs[i] = pipe.last_host_syncs if i else 0
            tracks = {t.id: t.state.value[0]
                      for t in pipe.tracker.active_tracks.values()}
            say(tag, f"frame {i}: {times[i]:.1f} ms, {len(dets[i])} "
                       f"detections, tracks {tracks}, host syncs "
                       f"{syncs[i]}")
        summary = profile_frames(
            lambda: [frame(i) for i in DYN_PROFILE_FRAMES],
            len(DYN_PROFILE_FRAMES), out_dir, tag=f"{tag}-profile",
            name=f"profile_trace_{tag}.json") if profile else None
        pipe.finalize()
        if pipe.evaluation is not None:
            pipe.evaluation.close()
        # the GUI's view: the static render with every object volume
        # rendered (K2 on the instance configuration) and tinted in
        rendered = sum(1 for t in pipe.tracker.active_tracks.values()
                       if t.has_reconstruction() and t.frames)
        preview = pipe.composited_preview()
        torch.cuda.synchronize()
    finally:
        fused_dynamic.integrate_many = recorder.fn
    launches = launch_counts()
    poses_gt = frames["poses"].astype(np.float64)
    # pose_history[k + 1] is frame k's pose (index 0 the identity prior)
    errs = [float(np.linalg.norm(
        np.linalg.inv(pipe.pose_history[k + 1].astype(np.float64))[:3, 3]
        - poses_gt[k][:3, 3])) for k in range(n)]
    return dict(pipe=pipe, times=times, syncs=syncs,
                census=(censuses[census_frames[0]][0] if census_frames
                        else Counter()), censuses=censuses,
                crops=crops, launches=launches, recorder=recorder, errs=errs,
                dispatches=pipe.current_frame_no - 1, profile=summary,
                preview=preview, rendered=rendered,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def check_dynamic(res, frames) -> dict:
    from dynslam_tpu_torch.instances.track import TrackState

    pipe = res["pipe"]
    n = frames["left"].shape[0]
    disp = res["dispatches"]
    want = dict(integrate=disp + res["recorder"].calls,
                candidates=disp + res["rendered"],
                raycast=disp + res["rendered"])
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


def check_integrate_many(rec, flush, parent=None, reps: int = 20,
                         plain_reps: int = 5) -> dict:
    """K1's volume axis (one launch over the recorded call's volumes)
    against ``integrate_ref`` volume by volume, on the same inputs, and
    its times."""
    import numpy as np
    import torch

    from dynslam_tpu_torch.device import upload
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
    wrapper_ms = median_ms(lambda: kernel(work), reps)
    dev = work.device
    vols_t = upload(np.asarray(vols, np.int32), dev)
    frames_t = upload(np.asarray(frames, np.int32), dev)
    launch = K1._launch_args(icfg, work, vols_t, slots, masks, rgb, depth,
                             w2c, intr4, frames_t)
    old = parent_launch(parent, "integrate", launch, lambda: parent_integrate(
        parent["integrate"], icfg, work, vols_t, slots, masks, depth, rgb,
        w2c, intr4, frames_t))
    times = kernel_times(launch, flush, old)
    plain_ms = median_ms(lambda: plain(work), plain_reps)
    pixels = [k1_pixels(icfg, work.block_coords[s], slots[i], masks[i],
                        w2c[i], intr4[i], *depth.shape[1:])
              for i, s in enumerate(vols)]
    return dict(vols=vols, blocks=blocks, pixels=pixels, exact=min(exact),
                max_abs_err=ds / 32767.0, dw=dw, dcolor=dc,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, **times,
                **integrate_bound(blocks, pixels, slots.shape[1]))


def check_instance_raycast(pipe, track, frames, flush, parent=None,
                           kernel_reps: int = 20,
                           plain_reps: int = 3) -> dict:
    """The pre-pass and K2 on the track's object volume from the camera of
    its last fused frame (``raycast_instance``'s inputs) against
    ``candidate_bits_ref`` and ``raycast_ref``, and their times."""
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
    pre = check_candidates(icfg, state, grid, origin, slots, mask, c2w,
                           flush, parent)
    pre.update(slots=slots, mask=mask)
    rargs = (icfg, state, grid, origin, pre["bits"], c2w, pipe.intr_vec)
    got = K2._march_cuda(*rargs)
    ref = K2.raycast_ref(*rargs)
    torch.cuda.synchronize()
    cmp = compare_march(got, ref, "K2 on an object volume")
    cmp["reads"] = march_reads(*rargs, ref)
    if cmp["hits"] < 500:
        raise AssertionError(f"K2 on an object volume: {cmp['hits']} hits "
                             "(need >= 500)")
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
    times = march_times(*rargs, flush, pre, parent, cmp, kernel_reps,
                        plain_reps)
    return dict(cmp, pre=pre, car_px=int(on_car.sum()),
                gt_err=err.abs().median().item(), gt_bias=err.median().item(),
                stereo_err=stereo_err.abs().median().item(),
                stereo_bias=stereo_err.median().item(),
                frame=f, track=track.id, **times)


# ---------------------------------------------------------------------------
# phases 10-12: the evaluation, and K2 in its crop viewport
# ---------------------------------------------------------------------------

#: the LIDAR ground truth of phases 10-11: every 2nd pixel of the rendered
#: depth, thinned to at most 120k points (a KITTI HDL-64 scan's size)
LIDAR_STRIDE, LIDAR_MAX_POINTS = 2, 120_000
#: phase 10: the fused render's correct share at the KITTI rule, correct /
#: (total - missing), on frames >= 2 (the LIDAR is exact ground truth)
MIN_KITTI_CORRECT = 0.9
#: phase 11 counts the syncs of the frame phase 8 counts and of the next,
#: which renders the object volumes for the evaluation, in its turns with
#: evaluation on and off
DYN_EVAL_CENSUS_FRAMES = (DYN_CENSUS_FRAME, DYN_CENSUS_FRAME + 1)


def write_lidar(config, frames, root: Path) -> float:
    """The synthetic rig's ``calib.txt`` and one LIDAR scan a frame
    (``make_velodyne_points`` of the frame's rendered depth) under
    ``root`` in the KITTI odometry layout; clears ``root/csv``. Returns
    the mean points a scan."""
    import shutil

    from dynslam_tpu_torch.io import synthetic as syn
    from dynslam_tpu_torch.io.calib import write_kitti_calibration
    from dynslam_tpu_torch.io.velodyne import write_frame

    kcal = syn.make_calibration(config.intrinsics, config.calibration)
    shutil.rmtree(root / "csv", ignore_errors=True)
    root.mkdir(parents=True, exist_ok=True)
    write_kitti_calibration(str(root / "calib.txt"), kcal)
    n = []
    for f, depth in enumerate(frames["depth"]):
        pts = syn.make_velodyne_points(
            depth, config.intrinsics, kcal.velo_to_left_cam,
            stride=LIDAR_STRIDE, max_points=LIDAR_MAX_POINTS)
        write_frame(str(root / "velodyne" / f"{f:06d}.bin"), pts)
        n.append(len(pts))
    return sum(n) / len(n)


def eval_files(ev, keys=("unified", "static", "dynamic", "memory",
                         "tracker")) -> dict:
    """The evaluation's CSV files under ``base_csv_name``'s names, as
    lists of row dicts; raises if one of ``keys`` was not written."""
    import csv

    paths = dict(unified=ev.csv_unified, static=ev.csv_static,
                 dynamic=ev.csv_dynamic, memory=ev.csv_memory,
                 tracker=ev.csv_tracker)
    out = {}
    for k in keys:
        path = Path(paths[k].output_path)
        if not path.exists():
            raise AssertionError(f"evaluation: {path.name} not written")
        with open(path) as f:
            out[k] = list(csv.DictReader(f))
    return out


def kitti_share(row) -> float:
    """A depth row's fused correct share at the KITTI rule, correct /
    (total - missing)."""
    c, t, m = (int(row[f"fusion-{k}-3.00-kitti"])
               for k in ("correct", "total", "missing"))
    return c / (t - m) if t > m else 0.0


def eval_job_cost(ev, frame: int, outputs, out_dir: Path) -> dict:
    """One LIDAR job of the evaluation's worker (scan read, upload, eval,
    fetch) run on this thread under torch.profiler: its kernel launches,
    memsets and copies, and its wall time; then the device time of the
    eval alone (``evaluate_depth_packed``, CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dynslam_tpu_torch.eval.evaluation import evaluate_depth_packed

    o = outputs
    ev._eval_job(frame, o.raycast.depth, o.depth_m, None, o.used_blocks,
                 o.decayed_blocks)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev._eval_job(frame, o.raycast.depth, o.depth_m, None, o.used_blocks,
                     o.decayed_blocks)
        wall = (time.perf_counter() - t0) * 1e3
    trace = out_dir / "profile_trace_eval.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    count = Counter(e.get("cat") for e in events)
    lidar = ev._lidar(ev.velodyne.read_frame(frame))
    zero = torch.zeros(o.depth_m.shape, dtype=torch.int8,
                       device=o.depth_m.device)
    device_ms = median_ms(lambda: evaluate_depth_packed(
        lidar, ev._velo_to_cam, ev._proj, o.raycast.depth, o.depth_m, zero,
        ev._consts, o.used_blocks, o.decayed_blocks, ev._all_deltas,
        ev._kitti_flags), 10)
    return dict(kernels=count["kernel"], memsets=count["gpu_memset"],
                copies=count["gpu_memcpy"], wall_ms=wall,
                device_ms=device_ms, points=int(lidar.shape[0]))


def same_syncs(on: Counter, off: Counter, what: str) -> int:
    """Raise unless the frame thread's sync sites and counts with
    evaluation on equal those with it off (two runs of one phase, both
    after the process's first use of every constant); returns the count
    with it on."""
    if on != off:
        raise AssertionError(
            f"{what}: host syncs on the frame thread with evaluation on "
            f"{dict(on.most_common())}, off {dict(off.most_common())}")
    return sum(on.values())


def check_static_eval(res, off: dict, config) -> dict:
    """Phase 10: the static slice with evaluation on (``res``) beside an
    eval-off run of the same phase (``off``)."""
    on = check_slice(res, N_FRAMES, config)
    ev = res["pipe"].evaluation
    files = eval_files(ev, ("unified", "static", "dynamic", "memory"))
    frames = [int(r["frame"]) for r in files["unified"]]
    if frames != list(range(1, N_FRAMES)):
        raise AssertionError(f"unified rows for frames {frames}, expected "
                             f"1-{N_FRAMES - 1} in order")
    mem = [(int(r["frame_id"]), int(r["memory_usage_bytes"]))
           for r in files["memory"]]
    if [f for f, _ in mem] != frames or not all(b > 0 for _, b in mem):
        raise AssertionError(f"memory rows {mem}")
    shares = {int(r["frame"]): kitti_share(r) for r in files["unified"]}
    low = {f: s for f, s in shares.items()
           if f >= 2 and s < MIN_KITTI_CORRECT}
    if low:
        raise AssertionError(f"KITTI-rule correct share below "
                             f"{MIN_KITTI_CORRECT} on frames {low}")
    n_on = same_syncs(res["census"], off["census"], f"frame {CENSUS_FRAME}")
    if not n_on:
        raise AssertionError(f"frame {CENSUS_FRAME}: no host sync counted")
    if ev.failed_fetches:
        raise AssertionError(f"{ev.failed_fetches} eval fetches failed")
    return dict(on, shares=shares, syncs=n_on, files=files,
                job_ms=list(ev.job_ms))


def check_dynamic_eval(res, off: dict) -> dict:
    """Phase 11: the dynamic slice with evaluation on (``res``) beside an
    eval-off run of the same phase (``off``), both with sync censuses of
    ``DYN_EVAL_CENSUS_FRAMES``."""
    pipe = res["pipe"]
    files = eval_files(pipe.evaluation)
    disp = res["dispatches"]
    renders = res["rendered"] + pipe.eval_crop_renders \
        + pipe.eval_full_renders
    want = dict(integrate=disp + res["recorder"].calls,
                candidates=disp + renders, raycast=disp + renders)
    if res["launches"] != want:
        raise AssertionError(
            f"dynamic slice with evaluation: launches {res['launches']}, "
            f"expected {want} ({pipe.eval_crop_renders} crop and "
            f"{pipe.eval_full_renders} full-frame eval renders)")
    frames = [int(r["frame"]) for r in files["unified"]]
    if frames != list(range(1, N_DYN)) or frames != [
            int(r["frame"]) for r in files["dynamic"]]:
        raise AssertionError(f"unified/dynamic rows for frames {frames}")
    dyn = files["dynamic"]
    total = sum(int(r["fusion-total-3.00"]) for r in dyn)
    hit = sum(int(r["fusion-total-3.00"]) - int(r["fusion-missing-3.00"])
              for r in dyn)
    if total == 0 or hit == 0:
        raise AssertionError(f"dynamic bucket: {total} points, {hit} with a "
                             "fused depth")
    trk = files["tracker"]
    recon = max(int(r["reconstructed_tracks"]) for r in trk)
    dropped = int(trk[-1]["dropped_detections_cum"])
    if recon < 1 or dropped != 0 or len(trk) != len(frames):
        raise AssertionError(f"tracker rows: {len(trk)}, at most {recon} "
                             f"reconstructed, {dropped} dropped")
    if pipe.eval_crop_renders < 1:
        raise AssertionError("no crop-viewport render ran")
    syncs = {f: same_syncs(res["censuses"][f][0], off["censuses"][f][0],
                           f"frame {f}") for f in DYN_EVAL_CENSUS_FRAMES}
    if pipe.evaluation.failed_fetches:
        raise AssertionError(
            f"{pipe.evaluation.failed_fetches} eval fetches failed")
    ms = [res["times"][i] for i in DYN_FPS_FRAMES]
    return dict(fps=len(ms) / (sum(ms) / 1e3), ms=ms, files=files,
                total=total, hit=hit, recon=recon, syncs=syncs,
                job_ms=list(pipe.evaluation.job_ms),
                shares=[kitti_share(r) for r in files["unified"]])


def check_crop_raycast(pipe, crops: CropRecorder, flush, parent=None,
                       kernel_reps: int = 20, plain_reps: int = 3) -> dict:
    """Phase 12: the pre-pass and K2 in the crop viewport — the largest
    object volume at the end of phase 11, in the viewport of its last crop
    render there — against
    ``candidate_bits_ref`` and ``raycast_ref``, and their times; and the
    march in a viewport 3 rows and 5 columns smaller, whose 8x4 tiles do
    not divide it."""
    import torch

    from dynslam_tpu_torch.ops import raycast as K2
    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.utils.se3 import inverse

    icfg = pipe.icfg_render
    slot, rec = max(crops.last.items(), key=lambda kv: int(
        tsdf.pool_slot(pipe.carry.inst, kv[0]).valid.sum()))
    state = tsdf.pool_slot(pipe.carry.inst, slot)
    u0, v0 = rec["u0"], rec["v0"]
    fx, fy, cx, cy = (float(x) for x in pipe.intr_host)
    dev = pipe.device
    c2w = torch.tensor(rec["c2w"], dtype=torch.float32, device=dev)
    intr = torch.tensor([fx, fy, cx - u0, cy - v0], dtype=torch.float32,
                        device=dev)
    origin = tsdf.compute_origin(icfg, c2w)
    grid = tsdf.build_local_grid(icfg, state, origin)
    slots, mask = tsdf.visible_blocks(icfg, state, grid, origin,
                                      inverse(c2w), intr4=intr)
    pre = check_candidates(icfg, state, grid, origin, slots, mask, c2w,
                           flush, parent)
    pre.update(slots=slots, mask=mask)
    rargs = (icfg, state, grid, origin, pre["bits"], c2w, intr)
    got = K2._march_cuda(*rargs)
    ref = K2.raycast_ref(*rargs)
    torch.cuda.synchronize()
    cmp = compare_march(got, ref, "K2 in the crop viewport")
    cmp["reads"] = march_reads(*rargs, ref)
    if cmp["hits"] < 200:
        raise AssertionError(f"K2 in the crop viewport: {cmp['hits']} hits "
                             "(need >= 200)")
    ecfg = dataclasses.replace(icfg, height=icfg.height - 3,
                               width=icfg.width - 5)
    eargs = (ecfg, state, grid, origin, pre["bits"], c2w, intr)
    edge = compare_march(K2._march_cuda(*eargs), K2.raycast_ref(*eargs),
                         f"K2 in a {ecfg.height}x{ecfg.width} crop viewport")
    times = march_times(*rargs, flush, pre, parent, cmp, kernel_reps,
                        plain_reps)
    return dict(cmp, pre=pre, slot=slot, u0=u0, v0=v0, edge=edge,
                edge_hw=(ecfg.height, ecfg.width),
                blocks=int(state.valid.sum()), **times)


# ---------------------------------------------------------------------------
# phases 13-15: the staged pipeline through the CLI, and the kernels in its
# roles
# ---------------------------------------------------------------------------

#: phase 13: the CLI's evaluation delay and preview period, the split run's
#: checkpoint frame and the frame whose host syncs are counted
STAGED_DELAY, STAGED_PREVIEWS, STAGED_SPLIT = 2, 4, 8
STAGED_CENSUS_FRAME = 6
#: phase 13's split run against the continuous one (tests/test_checkpoint.py)
SPLIT_BLOCKS_RTOL, SPLIT_PREFIX_ATOL = 0.15, 1e-6


def write_staged_sequence(config, frames, root: Path) -> float:
    """Phase 8's frames as a KITTI-odometry folder under ``root``, written
    with the port's writers: the colour pair (the gray frames in three
    channels), the ELAS depth dumps of the rendered depth, the MNC dumps of
    the dynamic boxes, ``calib.txt``, the ground-truth poses and LIDAR as
    phase 10 writes it. Returns the mean LIDAR points a scan."""
    import shutil

    import numpy as np

    from dynslam_tpu_torch.io import synthetic as syn
    from dynslam_tpu_torch.io.calib import write_kitti_poses

    shutil.rmtree(root, ignore_errors=True)
    pts = write_lidar(config, frames, root)
    for sub in ("image_2", "image_3", "precomputed-depth/Frames",
                "seg_image_2/mnc"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    write_kitti_poses(str(root / "ground-truth-poses.txt"),
                      frames["poses"].astype(np.float64))
    for f in range(frames["left"].shape[0]):
        objid = frames["objid"][f]
        syn.write_kitti_frame(
            str(root), f, np.repeat(frames["left"][f][..., None], 3, -1),
            np.repeat(frames["right"][f][..., None], 3, -1),
            frames["depth"][f],
            object_masks=[objid == k for k in np.unique(objid) if k > 0])
    return pts


class StagedProbe:
    """Instruments the staged pipeline while the CLI drives it: per frame
    (``DynSlam.process_frame``, synchronised at its end) the kernels'
    launches, the pool flushes and object renders, the renderable tracks
    and the wall time, the host syncs of one frame; the tinted pixels of
    each composited colour preview; the flush over the most volumes
    (``FusionRecorder``) for phase 14. Launches made between frames (the
    previews) count in the totals only."""

    def __init__(self, census_frame: Optional[int] = None):
        self.census_frame = census_frame
        self.frames, self.tinted, self.census = {}, [], Counter()
        self.dyn, self.pool_renders = None, 0

    def __enter__(self):
        from dynslam_tpu_torch.instances import volume_pool
        from dynslam_tpu_torch.pipeline.dynslam import DynSlam
        from dynslam_tpu_torch.pipeline.mapping import PreviewType

        self._saved = (DynSlam.process_frame,
                       DynSlam.get_static_map_raycast_preview,
                       volume_pool.InstanceVolumePool.raycast,
                       volume_pool.integrate_many)
        process, composite, raycast, _ = self._saved
        self.recorder = FusionRecorder(volume_pool.integrate_many)
        volume_pool.integrate_many = self.recorder
        probe = self

        def process_frame(dyn, input_):
            return probe._frame(process, dyn, input_)

        def composited(dyn, cam_to_world=None, preview=PreviewType.COLOR,
                       compositing=True):
            img = composite(dyn, cam_to_world, preview, compositing)
            if preview == PreviewType.COLOR and compositing:
                plain = dyn.static_scene.get_image(preview, cam_to_world)
                probe.tinted.append((dyn.current_frame_no - 1, int(
                    (img != plain).any(-1).sum())))
            return img

        def pool_raycast(pool, slot, cam_to_world):
            probe.pool_renders += 1
            return raycast(pool, slot, cam_to_world)

        DynSlam.process_frame = process_frame
        DynSlam.get_static_map_raycast_preview = composited
        volume_pool.InstanceVolumePool.raycast = pool_raycast
        return self

    def __exit__(self, *exc):
        from dynslam_tpu_torch.instances import volume_pool
        from dynslam_tpu_torch.pipeline.dynslam import DynSlam

        (DynSlam.process_frame, DynSlam.get_static_map_raycast_preview,
         volume_pool.InstanceVolumePool.raycast,
         volume_pool.integrate_many) = self._saved

    def _counts(self):
        from dynslam_tpu_torch.ops import integrate as K1
        from dynslam_tpu_torch.ops import raycast as K2

        return (K1.integrate.launches, K2.candidate_bits.launches,
                K2.raycast.launches, self.recorder.calls, self.pool_renders)

    def _frame(self, process, dyn, input_):
        import torch

        self.dyn = dyn
        n = dyn.current_frame_no
        rec = dyn.instance_reconstructor
        had = set() if rec is None else {
            t.id for t in rec.tracker.active_tracks.values()
            if t.has_reconstruction()}
        before = self._counts()
        t0 = time.perf_counter()
        out = []
        if n == self.census_frame:
            self.census, _ = count_syncs(
                lambda: out.append(process(dyn, input_)))
        else:
            out.append(process(dyn, input_))
        torch.cuda.synchronize()
        if out[0]:
            tracks = [] if rec is None else list(
                rec.tracker.active_tracks.values())
            self.frames[n] = dict(
                ms=(time.perf_counter() - t0) * 1e3,
                renderable=len(rec._active_renderable_tracks())
                if rec is not None else 0,
                # a volume initialised this frame fuses its earlier views
                # in a chain of flushes (one per view: the chain is
                # sequential per volume)
                catchup=max([len(t.frames) for t in tracks
                             if t.has_reconstruction() and t.id not in had],
                            default=0),
                **dict(zip(("k1", "pre", "march", "flushes", "pool"),
                           (a - b for a, b in zip(self._counts(), before)))))
        return out[0]


def run_cli(args, census_frame=None) -> StagedProbe:
    """``dynslam_tpu_torch.main.main(args)`` in this process under a
    ``StagedProbe``; the kernels' launch counts are set to 0 just before
    and read just after."""
    import torch

    from dynslam_tpu_torch import main as cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with StagedProbe(census_frame) as probe:
        t0 = time.perf_counter()
        rc = cli.main([str(a) for a in args])
        probe.wall_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"dynslam_tpu_torch.main exited {rc}")
    probe.launches = launch_counts()
    probe.peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return probe


def check_staged(probe, frames, out: Path) -> dict:
    """Phase 13's checks of the continuous run."""
    import numpy as np

    from dynslam_tpu_torch.instances.track import TrackState
    from dynslam_tpu_torch.instances.volume_pool import PooledVolume
    from dynslam_tpu_torch.io.calib import read_kitti_poses

    dyn, n = probe.dyn, frames["left"].shape[0]
    if sorted(probe.frames) != list(range(n)):
        raise AssertionError(f"frames run: {sorted(probe.frames)}")
    traj = read_kitti_poses(str(out / "trajectory.txt"))
    if traj.shape[0] != n:
        raise AssertionError(f"trajectory rows {traj.shape[0]} != {n}")
    travelled = SPEED * (n - 1)
    err = float(np.linalg.norm(traj[-1][:3, 3]
                               - frames["poses"][n - 1][:3, 3]))
    if not err <= 0.02 * travelled:
        raise AssertionError(f"final pose error {err:.3f} m > 2% of "
                             f"{travelled:.1f} m")
    recon = [(t.id, t.state.value, t.reconstruction.get_used_block_count())
             for t in dyn.instance_reconstructor.tracker.active_tracks
             .values() if isinstance(t.reconstruction, PooledVolume)]
    if not any(s == TrackState.DYNAMIC.value and b > 100
               for _, s, b in recon):
        raise AssertionError(f"no Dynamic track with a pooled volume of "
                             f"> 100 blocks: {recon}")
    dropped = dyn.static_scene.get_dropped_allocation_count()
    if dropped:
        raise AssertionError(f"{dropped} blocks dropped")
    files = eval_files(dyn.evaluation)
    shares = {b: {int(r["frame"]): kitti_share(r) for r in files[b]}
              for b in ("unified", "static", "dynamic")}
    for b, v in shares.items():
        if sorted(v) != list(range(n - STAGED_DELAY)):
            raise AssertionError(f"{b} rows for frames {sorted(v)}")
    mem = [int(r["frame_id"]) for r in files["memory"]]
    trk = [int(r["frame_id"]) for r in files["tracker"]]
    if mem != list(range(n)) or trk != mem:
        raise AssertionError(f"memory rows {mem}, tracker rows {trk}")
    if not probe.tinted or max(t for _, t in probe.tinted) < 100:
        raise AssertionError(f"tinted pixels in the colour previews: "
                             f"{probe.tinted}")
    for f, r in probe.frames.items():
        static = int(f >= 1)
        if r["flushes"] > max(1, r["catchup"]) \
                or r["k1"] != static + r["flushes"]:
            raise AssertionError(
                f"frame {f}: {r['k1']} K1 launches, {r['flushes']} pool "
                f"flushes, catch-up chain {r['catchup']}")
        for k in ("pre", "march"):
            if r[k] > 2 + r["renderable"]:
                raise AssertionError(
                    f"frame {f}: {r[k]} K2 {k} launches, {r['renderable']} "
                    "renderable tracks")
    ms = [probe.frames[i]["ms"] for i in DYN_FPS_FRAMES]
    return dict(err=err, travelled=travelled, recon=recon, files=files,
                shares=shares, fps=len(ms) / (sum(ms) / 1e3), ms=ms,
                blocks=dyn.static_scene.get_used_block_count())


def check_own_frame_eval(probe) -> dict:
    """The split run evaluates each frame at its own pose with its own
    segmentation (delay 0): the static bucket's KITTI-rule correct share
    >= 0.9 from frame 2 (the input depth and the LIDAR are exact ground
    truth). With delay 2 the reference routes a past frame with the
    latest detections and renders the objects' latest volumes at the past
    pose, so moving cars count against it (printed, not held)."""
    files = eval_files(probe.dyn.evaluation, ("unified", "static",
                                              "dynamic"))
    shares = {b: {int(r["frame"]): kitti_share(r) for r in files[b]}
              for b in files}
    low = {f: v for f, v in shares["static"].items()
           if f >= 2 and v < MIN_KITTI_CORRECT}
    if sorted(shares["static"]) != list(range(STAGED_SPLIT)) or low:
        raise AssertionError(f"static bucket's KITTI-rule share below "
                             f"{MIN_KITTI_CORRECT} on frames {low} (rows "
                             f"{sorted(shares['static'])})")
    return shares


def check_split(cont, resumed, out_cont: Path, out_resumed: Path) -> dict:
    """tests/test_checkpoint.py's criteria: equal frame counts, the
    checkpointed prefix of the trajectory equal, used blocks within 15%."""
    import numpy as np

    from dynslam_tpu_torch.io.calib import read_kitti_poses

    a = read_kitti_poses(str(out_cont / "trajectory.txt"))
    b = read_kitti_poses(str(out_resumed / "trajectory.txt"))
    if a.shape != b.shape or cont.dyn.current_frame_no \
            != resumed.dyn.current_frame_no:
        raise AssertionError(f"trajectories {a.shape} / {b.shape}")
    gap = float(np.abs(a[:STAGED_SPLIT] - b[:STAGED_SPLIT]).max())
    if gap > SPLIT_PREFIX_ATOL:
        raise AssertionError(f"checkpointed prefix differs by {gap:.3g}")
    ua = cont.dyn.static_scene.get_used_block_count()
    ub = resumed.dyn.static_scene.get_used_block_count()
    if abs(ua - ub) > SPLIT_BLOCKS_RTOL * ua:
        raise AssertionError(f"used blocks {ub} vs {ua} continuous")
    return dict(gap=gap, blocks=(ua, ub),
                frames=sorted(resumed.frames))


def free_pose(c2w, up=3.0, back=6.0, pitch_deg=15.0):
    """A preview pose off the trajectory: ``up`` m above and ``back`` m
    behind the camera, pitched ``pitch_deg`` down."""
    import numpy as np

    a = np.radians(pitch_deg)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    out = np.asarray(c2w, np.float64).copy()
    out[:3, :3] = out[:3, :3] @ rx.T
    out[:3, 3] = out[:3, 3] + out[:3, :3] @ np.array([0.0, -up, -back])
    return out.astype(np.float32)


def check_view_raycast(cfg, state, c2w_np, intr, flush, parent, what,
                       min_hits: int, kernel_reps: int = 20,
                       plain_reps: int = 3) -> dict:
    """The pre-pass and K2 on ``state`` from ``c2w_np`` (host 4x4), the
    window and visible list built at that pose as ``MapEngine`` and the
    pool build them, against ``candidate_bits_ref`` and ``raycast_ref``,
    and their times."""
    import torch

    from dynslam_tpu_torch.ops import raycast as K2
    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.pipeline.mapping import lu_inverse_np

    dev = state.device
    c2w = torch.tensor(c2w_np, dtype=torch.float32, device=dev)
    w2c = torch.tensor(lu_inverse_np(c2w_np), device=dev)
    origin = tsdf.compute_origin(cfg, c2w)
    grid = tsdf.build_local_grid(cfg, state, origin)
    slots, mask = tsdf.visible_blocks(cfg, state, grid, origin, w2c)
    pre = check_candidates(cfg, state, grid, origin, slots, mask, c2w,
                           flush, parent)
    pre.update(slots=slots, mask=mask)
    rargs = (cfg, state, grid, origin, pre["bits"], c2w, intr)
    got = K2._march_cuda(*rargs)
    ref = K2.raycast_ref(*rargs)
    torch.cuda.synchronize()
    cmp = compare_march(got, ref, what)
    cmp["reads"] = march_reads(*rargs, ref)
    if cmp["hits"] < min_hits:
        raise AssertionError(f"{what}: {cmp['hits']} hits (need >= "
                             f"{min_hits})")
    times = march_times(*rargs, flush, pre, parent, cmp, kernel_reps,
                        plain_reps)
    return dict(cmp, pre=pre, **times)


# ---------------------------------------------------------------------------
# phase 16: the CLI's last outputs (prefetching input, meshes, direct
# refinement, the LIDAR error overlay, the renderer, the dense tracer)
# ---------------------------------------------------------------------------

#: 16a: the split run's frames whose rate is compared
PREFETCH_FPS_FRAMES = range(3, STAGED_SPLIT)
#: 16b: the static mesh's floor (PERF.md's prediction: 0.4-1.5 M)
MIN_STATIC_TRIS = 100_000
#: 16c: orbit frames and the chase camera's pose stride
ORBIT_FRAMES, CHASE_EVERY = 8, 4
#: 16d: the dense tracer's size (half the frame) and its bounds against
#: the same function on a CPU copy of the map
TRACER_W, TRACER_H = W // 2, (H + 1) // 2
TRACER_MIN_HIT_AGREE, TRACER_MAX_MEDIAN = 0.999, 1e-4


class Tee:
    """Standard output that is also kept in ``text``."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    @property
    def text(self) -> str:
        return "".join(self.parts)


class Timed:
    """Replaces ``owner.name`` for the ``with`` block: each call is
    synchronised and timed, and the K2 launches inside it counted."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.ms, self.pre, self.march = [], 0, 0

    def __enter__(self):
        import torch

        from dynslam_tpu_torch.ops import raycast as K2

        fn = self.fn = getattr(self.owner, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            pre, march = K2.candidate_bits.launches, K2.raycast.launches
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.pre += K2.candidate_bits.launches - pre
            self.march += K2.raycast.launches - march
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def frame_rate(probe, frames) -> float:
    ms = [probe.frames[i]["ms"] for i in frames]
    return len(ms) / (sum(ms) / 1e3)


def check_prefetch(split, pre, out_split: Path, out_pre: Path) -> dict:
    """16a: the prefetching run's trajectory and CSVs byte for byte those of
    phase 13's split run; both runs' read stage and frame rate."""
    import filecmp

    names = sorted(os.listdir(out_split / "csv"))
    if not names or names != sorted(os.listdir(out_pre / "csv")):
        raise AssertionError(f"CSVs {names} / "
                             f"{sorted(os.listdir(out_pre / 'csv'))}")
    files = ["trajectory.txt"] + [f"csv/{n}" for n in names]
    differ = [f for f in files
              if not filecmp.cmp(out_split / f, out_pre / f, shallow=False)]
    if differ:
        raise AssertionError(f"--prefetch changed {differ}")
    return dict(files=files, read_ms=[
        p.dyn._timers.mean_ms("1-read-input") for p in (split, pre)],
        fps=[frame_rate(p, PREFETCH_FPS_FRAMES) for p in (split, pre)])


def read_obj(path: Path):
    """(vertex count, (T, 3) 1-based faces) of an OBJ file."""
    import numpy as np

    lines = path.read_text().splitlines()
    n_v = sum(ln.startswith("v ") for ln in lines)
    faces = np.array(" ".join(ln[2:] for ln in lines if ln.startswith("f "))
                     .split(), np.int64).reshape(-1, 3)
    return n_v, faces


def check_refine_run(probe, printed: str, refine: Timed, overlay: Timed,
                     frames, out: Path) -> dict:
    """16b: the staged CLI with meshes, direct refinement and the LIDAR
    error overlay: the static mesh parses with valid faces and more than
    ``MIN_STATIC_TRIS`` triangles, an object mesh has triangles, at least
    one object motion was refined (and printed), the poses are finite
    and drift <= 2%, the overlays of frames 4 and 8 have green splats."""
    import re

    import numpy as np

    from dynslam_tpu_torch.eval.error_viz import ERROR, GOOD
    from dynslam_tpu_torch.io.calib import read_kitti_poses
    from dynslam_tpu_torch.io.images import read_png

    n_v, faces = read_obj(out / "static_map.obj")
    if len(faces) < MIN_STATIC_TRIS or faces.min() < 1 or faces.max() > n_v:
        raise AssertionError(f"static_map.obj: {len(faces)} faces over "
                             f"{n_v} vertices, indices {faces.min()}-"
                             f"{faces.max()}")
    objs = {p.name: len(read_obj(p)[1]) for p in out.glob("object_*.obj")}
    if not objs or max(objs.values()) == 0:
        raise AssertionError(f"object meshes {objs}")
    rec = probe.dyn.instance_reconstructor
    said = re.findall(r"\[direct refinement: (\d+) object motions refined\]",
                      printed)
    if said != [str(rec.direct_refinements)] or rec.direct_refinements < 1:
        raise AssertionError(f"direct refinement printed {said}, "
                             f"{rec.direct_refinements} refined")
    n = frames["left"].shape[0]
    traj = read_kitti_poses(str(out / "trajectory.txt"))
    travelled = SPEED * (n - 1)
    err = float(np.linalg.norm(traj[-1][:3, 3]
                               - frames["poses"][n - 1][:3, 3]))
    if traj.shape[0] != n or not np.isfinite(traj).all() \
            or not err <= 0.02 * travelled:
        raise AssertionError(f"trajectory {traj.shape}, final pose error "
                             f"{err:.3f} m over {travelled:.1f} m")
    green = {}
    for f in (STAGED_PREVIEWS, 2 * STAGED_PREVIEWS):
        img = read_png(str(out / f"frame{f:06d}_lidar_error.png"))
        g = int((img == GOOD).all(-1).sum())
        r = int((img == ERROR).all(-1).sum())
        if img.shape != (H, W, 3) or g == 0:
            raise AssertionError(f"frame {f}'s overlay: {img.shape}, {g} "
                                 "green pixels")
        green[f] = (g, r, g / (g + r))
    return dict(tris=len(faces), verts=n_v, objs=objs,
                refined=rec.direct_refinements, refine_ms=refine.ms,
                overlay_pre=overlay.pre, overlay_march=overlay.march,
                err=err, travelled=travelled, green=green,
                fps=frame_rate(probe, DYN_FPS_FRAMES))


def check_renderer(dyn, out_dir: Path) -> dict:
    """16c: ``render_orbit`` of the static map (under torch.profiler, each
    K2 call in a ``render.k2`` range) and ``render_chase_sequence`` every
    ``CHASE_EVERY`` poses, the launch counts set to 0 just before and read
    just after: every PNG written, every orbit frame with hits, one K2
    pre-pass and march a render, at most ``RAYCAST_STAGE_MAX_LAUNCHES``
    launches and memsets in K2's range."""
    from torch.profiler import record_function

    from dynslam_tpu_torch.pipeline import mapping
    from dynslam_tpu_torch.viz import renderer

    k2, hits, paths = mapping.raycast, [], []

    def traced(*args, **kwargs):
        with record_function("render.k2"):
            out = k2(*args, **kwargs)
        hits.append(out.hit.sum())
        return out

    reset_launches()
    mapping.raycast = traced
    try:
        prof = profile_frames(
            lambda: paths.extend(renderer.render_orbit(
                dyn.static_scene, str(out_dir / "orbit"),
                n_frames=ORBIT_FRAMES)),
            ORBIT_FRAMES, out_dir, tag="render-profile",
            name="profile_trace_orbit.json")
    finally:
        mapping.raycast = k2
    orbit = launch_counts()
    chase = renderer.render_chase_sequence(dyn, str(out_dir / "chase"),
                                           every=CHASE_EVERY)
    launches = launch_counts()
    _, _, kernels, memsets = prof["stages"]["render.k2"]
    hits = [int(h) for h in hits]
    want_chase = len(range(0, len(dyn.pose_history) - 1, CHASE_EVERY))
    if len(paths) != ORBIT_FRAMES or len(chase) != want_chase \
            or not all(os.path.exists(p) for p in paths + chase):
        raise AssertionError(f"{len(paths)} orbit and {len(chase)} chase "
                             "PNGs")
    if len(hits) != ORBIT_FRAMES or min(hits) == 0:
        raise AssertionError(f"orbit hits {hits}")
    if orbit != dict(integrate=0, candidates=ORBIT_FRAMES,
                     raycast=ORBIT_FRAMES) \
            or kernels + memsets > RAYCAST_STAGE_MAX_LAUNCHES:
        raise AssertionError(f"orbit K2 launches {orbit}, {kernels:.0f} "
                             f"kernels and {memsets:.0f} memsets a render")
    return dict(hits=hits, chase=len(chase), orbit=orbit, launches=launches,
                kernels=kernels, memsets=memsets,
                renders=ORBIT_FRAMES + len(chase))


def cpu_state(state):
    from dynslam_tpu_torch.ops import tsdf

    return tsdf.TsdfState(*(getattr(state, f.name).cpu()
                            for f in dataclasses.fields(state)))


def check_tracer(eng, out_dir: Path) -> dict:
    """16d: ``MapEngine.get_raycast`` at ``TRACER_W`` x ``TRACER_H`` (the
    dense tracer) from the current pose on the card against the same call
    on a CPU copy of the map; its time (CUDA events, median of 5) and its
    launches (one call under torch.profiler)."""
    import numpy as np

    from dynslam_tpu_torch.pipeline.mapping import MapEngine

    pose = eng.cam_to_world

    def render():
        return eng.get_raycast(pose, TRACER_W, TRACER_H)

    got = render()
    ref_eng = MapEngine(eng.cfg, eng.decay_params, device="cpu")
    ref_eng.state = cpu_state(eng.state)
    ref_eng.intrinsics_vec = eng.intrinsics_vec.cpu()
    t0 = time.perf_counter()
    ref = ref_eng.get_raycast(pose, TRACER_W, TRACER_H)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    hg, hr = got.hit.cpu().numpy(), ref.hit.numpy()
    both = hg & hr
    gap = np.abs(got.depth.cpu().numpy() - ref.depth.numpy())[both]
    agree = float((hg == hr).mean())
    median = float(np.median(gap)) if gap.size else float("inf")
    if hg.shape != (TRACER_H, TRACER_W) or both.sum() < 1000 \
            or agree < TRACER_MIN_HIT_AGREE or median > TRACER_MAX_MEDIAN:
        raise AssertionError(f"dense tracer vs its CPU run: {hg.shape}, "
                             f"{both.sum()} common hits, agreement {agree}, "
                             f"median |ddepth| {median}")
    prof = profile_frames(render, 1, out_dir, tag="tracer-profile",
                          name="profile_trace_tracer.json")
    return dict(agree=agree, median=median, max=float(gap.max()),
                hits=int(hg.sum()), ms=median_ms(render, 5), cpu_ms=cpu_ms,
                kernels=prof["kernels"], memsets=prof["memsets"],
                samples=int(got.march_samples))


def check_mesh(state, voxel_size: float) -> dict:
    """16e: ``extract_mesh`` on the card against the same function on a
    CPU copy of the map: the same vertices and triangles, in order."""
    import torch

    from dynslam_tpu_torch.viz.meshing import extract_mesh

    v, t = extract_mesh(state, voxel_size)
    ms = median_ms(lambda: extract_mesh(state, voxel_size), 3)
    host = cpu_state(state)
    t0 = time.perf_counter()
    vc, tc = extract_mesh(host, voxel_size)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(v.cpu(), vc) and torch.equal(t.cpu(), tc)):
        differ = int((v.cpu() != vc).any(1).sum()) \
            if v.shape == vc.shape else "?"
        raise AssertionError(
            f"extract_mesh on the card: {tuple(v.shape)} vertices, "
            f"{tuple(t.shape)} triangles; on the CPU {tuple(vc.shape)}, "
            f"{tuple(tc.shape)}; {differ} vertices differ")
    return dict(verts=int(v.shape[0]), tris=int(t.shape[0]), ms=ms,
                cpu_ms=cpu_ms)


def run_phase16(base, sdir: Path, split, dyn_frames, dyn, k2f):
    """Phase 16 on phase 13's folder (``base``: its CLI arguments,
    ``split``: its split run) with phase 8's largest track (``dyn``)
    and phase 15's free-pose K2 times (``k2f``), for comparison.
    Returns what the kernels line reports launches of: the prefetching
    run, the run with meshes, the overlays' ``Timed`` and the renders."""
    # 16a. phase 13's split run again with the prefetching reader
    pre16 = run_cli(base + ["--out", sdir / "out_prefetch", "--frame_limit",
                            STAGED_SPLIT, "--checkpoint_out",
                            sdir / "split_prefetch.npz",
                            "--enable_evaluation", "--prefetch"])
    pf = check_prefetch(split, pre16, sdir / "out_split",
                        sdir / "out_prefetch")
    say("prefetch", f"--prefetch: {', '.join(pf['files'])} byte-identical to"
                    f" phase 13's split run; 1-read-input mean "
                    f"{pf['read_ms'][1]:.2f} ms a frame (without: "
                    f"{pf['read_ms'][0]:.2f}); "
                    f"{pf['fps'][1]:.2f} FPS over frames "
                    f"{PREFETCH_FPS_FRAMES.start}-"
                    f"{PREFETCH_FPS_FRAMES.stop - 1} (without: "
                    f"{pf['fps'][0]:.2f})")

    # 16b. meshes, direct refinement and the LIDAR error overlay
    from dynslam_tpu_torch import main as cli
    from dynslam_tpu_torch.instances.reconstructor import (
        InstanceReconstructor,
    )

    out16 = sdir / "out_refine"
    tee = Tee(sys.stdout)
    refine = Timed(InstanceReconstructor, "_direct_refine_motion")
    overlay = Timed(cli, "_write_lidar_error")
    with contextlib.redirect_stdout(tee), refine, overlay:
        rb = run_cli(base + ["--out", out16, "--enable_evaluation",
                             "--dump_previews_every", STAGED_PREVIEWS,
                             "--save_mesh", "--save_object_meshes",
                             "--direct_refinement"])
    rf = check_refine_run(rb, tee.text, refine, overlay, dyn_frames, out16)
    say("refine", f"--save_mesh: static_map.obj {rf['tris']} triangles over "
                  f"{rf['verts']} vertices (need >= {MIN_STATIC_TRIS}); "
                  f"object meshes {rf['objs']}; {rf['refined']} object "
                  f"motions refined in {len(rf['refine_ms'])} calls, "
                  f"{sum(rf['refine_ms']):.1f} ms in all ("
                  f"{sum(rf['refine_ms']) / N_DYN:.1f} ms a frame, median "
                  f"{statistics.median(rf['refine_ms']):.1f} a call); "
                  f"{rf['fps']:.2f} FPS over frames {DYN_FPS_FRAMES.start}-"
                  f"{DYN_FPS_FRAMES.stop - 1}; final pose error "
                  f"{rf['err'] * 100:.2f} cm over {rf['travelled']:.1f} m; "
                  f"launches {rb.launches}")
    say("refine", f"LIDAR error overlays at {W}x{H} (green, red, "
                  "green/(green+red)): " + "; ".join(
                      f"frame {f} {g} {r} {s:.4f}"
                      for f, (g, r, s) in rf["green"].items())
        + f"; {overlay.pre} K2 pre-passes and {overlay.march} marches in "
          f"{len(overlay.ms)} overlays (the objects' depth renders)")

    # 16c. the renderer
    rr = check_renderer(rb.dyn, sdir / "render")
    say("render", f"render_orbit {ORBIT_FRAMES} frames (hits {rr['hits']}),"
                  f" render_chase_sequence {rr['chase']} frames; K2 launches "
                  f"{rr['launches']} (orbit {rr['orbit']}); in K2's range "
                  f"{rr['kernels']:.0f} launches and {rr['memsets']:.0f} "
                  f"memsets a render")

    # 16d. the dense tracer at half the frame
    tr = check_tracer(rb.dyn.static_scene, sdir / "render")
    say("tracer", f"MapEngine.get_raycast at {TRACER_W}x{TRACER_H} (the "
                  f"dense tracer) vs its CPU run: hit agreement "
                  f"{tr['agree'] * 100:.4f}%, median |ddepth| "
                  f"{tr['median']:.3g} m, max {tr['max']:.3g} m, {tr['hits']}"
                  f" hits, {tr['samples']} samples; {tr['ms']:.2f} ms a "
                  f"render, {tr['kernels']} launches and {tr['memsets']} "
                  f"memsets (CPU {tr['cpu_ms']:.1f} ms); K2 at {W}x{H} from "
                  f"the free pose: {k2f['kernel_ms']:.4f} ms bare, "
                  f"{k2f['wrapper_ms']:.4f} ms wrapper, 2 launches")

    # 16e. extract_mesh on the card vs the CPU
    ms16 = check_mesh(rb.dyn.static_scene.state,
                      rb.dyn.static_scene.cfg.voxel_size)
    if ms16["tris"] != rf["tris"]:
        raise AssertionError(f"extract_mesh {ms16['tris']} triangles, "
                             f"static_map.obj {rf['tris']}")
    handle = dyn["track"].reconstruction
    mslot = check_mesh(handle.state, handle.cfg.voxel_size)
    if mslot["tris"] == 0:
        raise AssertionError(f"phase 8's slot {handle.slot}: no triangles")
    say("mesh", f"extract_mesh on the card equals its CPU run: the static "
                f"map {ms16['tris']} triangles, {ms16['verts']} vertices, "
                f"{ms16['ms']:.1f} ms (CPU {ms16['cpu_ms']:.1f} ms); phase "
                f"8's largest slot ({handle.slot}, track {dyn['track'].id}) "
                f"{mslot['tris']} triangles, {mslot['ms']:.1f} ms (CPU "
                f"{mslot['cpu_ms']:.1f} ms)")
    return pre16, rb, overlay, rr


# ---------------------------------------------------------------------------
# phase 17: the learned models, sharding, and batch evaluation of sequence
# maps
# ---------------------------------------------------------------------------

#: 17a: DispNet-lite's training on the static frames (Adam), the loss fall
#: it must reach (the mean of the last 5 steps' losses over the first
#: step's), and its forward on the card against a CPU copy, TF32 off (px)
DISP_STEPS, DISP_BATCH, DISP_LR, DISP_MAX_LOSS_FALL = 30, 2, 1e-3, 0.7
DISP_FWD_ATOL = 1e-3
#: 17b: SegNet-lite's training on the dynamic frames but the last (held
#: out), the overlap (IoU) a detection must reach with one car's truth
#: pixels there (200 steps could leave a frame-wide blob that covers a
#: car but overlaps it by 0.12), and the detections' agreement with a
#: CPU copy of the model
SEG_STEPS, SEG_BATCH, SEG_LR = 600, 2, 3e-3
MIN_CAR_IOU, SEG_MIN_MASK_AGREE = 0.5, 0.999
#: 17c: the sharded step at world size 1 against the unsharded one, both
#: on the card: the losses (relative), and the parameters after the steps
#: (Adam turns a gradient near 0 into a step of ~lr, so a flip of its sign
#: between two runs costs up to 2 lr a step; the median tightly)
SHARD_STEPS, SHARD_LOSS_RTOL, SHARD_PARAM_MEDIAN = 3, 1e-5, 1e-6
#: 17d: sequences and frames of the batch evaluation (sequence s is static
#: frames s..s+3); JAX's test bounds on the last frame
#: (tests/test_batch_eval.py:71-72): mean |error| < 0.25 m and hit
#: fraction > 0.5, the latter of the pixels a render can hit (ground truth
#: within the fusion range; the bench frames' sky, ~40%, has none)
BE_SEQ, BE_FRAMES = 4, 4
BE_MAX_ERR_M, BE_MIN_HIT = 0.25, 0.5


def gray_rgb(gray, device):
    """Gray uint8 frames (N, H, W) as (N, 3, H, W) float32 in [0, 255] on
    ``device``, the models' input."""
    import torch

    g = torch.tensor(gray, dtype=torch.float32, device=device)
    return g[:, None].expand(-1, 3, -1, -1).contiguous()


def seeded_flax_params(model, seed: int) -> dict:
    """A Flax-layout param set for ``model``'s convolutions (``{"params":
    {"Conv_<i>": {"kernel" HWIO, "bias"}}}``, numpy) drawn from ``seed``:
    kernels lecun-normal (variance 1 / fan_in, clipped at 2 sigma), biases
    N(0, 0.01)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = {}
    for i, conv in enumerate(model.convs):
        cout, cin, kh, kw = conv.weight.shape
        std = (1.0 / (cin * kh * kw)) ** 0.5 / 0.87962566103423978
        kernel = np.clip(rng.standard_normal((kh, kw, cin, cout)), -2, 2) * std
        params[f"Conv_{i}"] = {
            "kernel": kernel.astype(np.float32),
            "bias": rng.normal(0.0, 0.01, cout).astype(np.float32)}
    return {"params": params}


def timed_ms(fn):
    """(fn(), its wall ms between two device synchronisations)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dispnet_data(config, frames, device) -> dict:
    """The static frames as DispNet-lite's training set: gray images as RGB,
    the true disparity ``bf / depth`` and its valid mask (depth known,
    disparity within the bench's stereo range), on the card."""
    import torch

    depth = torch.tensor(frames["depth"], device=device)
    bf = config.calibration.baseline_m * config.calibration.focal_length_px
    disp = torch.where(depth > 0, bf / depth.clamp(min=1e-6), 0.0)
    return dict(left=gray_rgb(frames["left"], device),
                right=gray_rgb(frames["right"], device), disparity=disp,
                valid=(depth > 0) & (disp <= config.stereo.max_disparity))


def seeded_dispnet(config, seed: int):
    from dynslam_tpu_torch.convert import flax_to_state_dict
    from dynslam_tpu_torch.models import dispnet

    model = dispnet.create_model(
        max_disparity=float(config.stereo.max_disparity))
    model.load_state_dict(flax_to_state_dict(seeded_flax_params(model, seed)))
    return model


def check_dispnet(config, frames, device) -> dict:
    """17a: a seeded Flax-layout param set converted to the module; its
    forward at the full frame on the card against a CPU copy, then
    ``DISP_STEPS`` Adam steps on batches of two static frames."""
    import copy

    import torch

    from dynslam_tpu_torch.models import dispnet

    model = seeded_dispnet(config, SEED)
    cpu = copy.deepcopy(model)
    model.to(device)
    data = dispnet_data(config, frames, device)
    left, right = data["left"][:1], data["right"][:1]
    with torch.no_grad():
        got = model(left, right)
        want = cpu(left.cpu(), right.cpu())
        err = float((got.cpu() - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > DISP_FWD_ATOL:
            raise AssertionError(f"DispNet-lite on the card vs a CPU copy: "
                                 f"max |d disparity| {err} px (bound "
                                 f"{DISP_FWD_ATOL})")
        infer_ms = median_ms(lambda: model(left, right), 20)
    step = dispnet.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=DISP_LR))
    n = data["left"].shape[0]
    losses, ms = [], []
    for it in range(DISP_STEPS):
        idx = [(it + 3 * j) % n for j in range(DISP_BATCH)]
        loss, t = timed_ms(lambda: step({k: v[idx] for k, v in data.items()}))
        losses.append(float(loss))
        ms.append(t)
    fall = statistics.mean(losses[-5:]) / losses[0]
    if not all(map(math.isfinite, losses)) or not fall < DISP_MAX_LOSS_FALL:
        raise AssertionError(f"DispNet-lite training: losses {losses}, the "
                             f"last 5 at {fall:.3f} of the first (need < "
                             f"{DISP_MAX_LOSS_FALL})")
    return dict(err=err, infer_ms=infer_ms, step_ms=statistics.median(ms[3:]),
                losses=losses, fall=fall,
                valid=float(data["valid"].float().mean()))


def check_segnet(frames, device, out_dir: Path) -> dict:
    """17b: SegNet-lite trained on the card against the dynamic frames' car
    masks, the learned provider on the held-out last frame (a detected
    car, the same detections from a CPU copy, ms a frame), and a
    ``save_params``/``load_params`` round trip."""
    import copy

    import numpy as np
    import torch

    from dynslam_tpu_torch.models import segnet

    model = segnet.init_params(segnet.create_model(),
                               torch.Generator().manual_seed(SEED))
    model.to(device)
    rgb = gray_rgb(frames["left"], device)
    cars = torch.tensor(frames["objid"] > 0, device=device)
    n = rgb.shape[0] - 1  # the last frame is held out
    step = segnet.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=SEG_LR))
    losses, ms = [], []
    for it in range(SEG_STEPS):
        idx = [(it + 5 * j) % n for j in range(SEG_BATCH)]
        loss, t = timed_ms(lambda: step(dict(rgb=rgb[idx], mask=cars[idx])))
        losses.append(float(loss))
        ms.append(t)
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    if not all(map(math.isfinite, losses)) or not last < first:
        raise AssertionError(f"SegNet-lite training: losses {losses[:10]} ... "
                             f"{losses[-10:]}")
    frame = np.repeat(frames["left"][n][..., None], 3, -1)
    truth = frames["objid"][n]
    prov = segnet.LearnedSegmentationProvider(model,
                                              min_detection_size_px=DET_MIN_PX)
    res = prov.segment_frame(frame)
    frame_ms = [timed_ms(lambda: prov.segment_frame(frame))[1]
                for _ in range(5)]
    found = []
    for d in res.instance_detections:
        pred = d.copy_mask.to_full_frame(*truth.shape)
        ids, counts = np.unique(truth[pred & (truth > 0)], return_counts=True)
        if ids.size:
            car = truth == ids[np.argmax(counts)]
            found.append((float((car & pred).sum() / car.sum()),
                          float((car & pred).sum() / (car | pred).sum())))
    if not found or max(iou for _, iou in found) <= MIN_CAR_IOU:
        raise AssertionError(f"SegNet-lite on held-out frame {n}: "
                             f"{len(res.instance_detections)} detections, "
                             f"(truth covered, IoU) of their cars {found}")
    got = prov.raw_detections(frame)
    want = segnet.LearnedSegmentationProvider(
        copy.deepcopy(model).cpu(),
        min_detection_size_px=DET_MIN_PX).raw_detections(frame)
    boxes = [[(b.x0, b.y0, b.x1, b.y1) for b, *_ in dets]
             for dets in (got, want)]
    agree = min((g[3] == w[3]).mean() for g, w in zip(got, want)) \
        if boxes[0] == boxes[1] else 0.0
    if boxes[0] != boxes[1] or agree < SEG_MIN_MASK_AGREE:
        raise AssertionError(f"the provider on the card vs a CPU copy: boxes "
                             f"{boxes[0]} vs {boxes[1]}, mask agreement "
                             f"{agree} (need >= {SEG_MIN_MASK_AGREE})")
    path = out_dir / "segnet.msgpack"
    segnet.save_params(str(path), model)
    back = segnet.load_params(str(path), segnet.create_model())
    for k, v in model.state_dict().items():
        if not torch.equal(back.state_dict()[k], v.cpu()):
            raise AssertionError(f"save_params/load_params: {k} differs")
    return dict(step_ms=statistics.median(ms[3:]), losses=losses,
                frame_ms=statistics.median(frame_ms), held_out=n,
                detections=len(res.instance_detections), found=found,
                boxes=boxes[0], agree=agree, bytes=path.stat().st_size)


def check_sharding(config, frames, device) -> dict:
    """17c: the sharded DispNet-lite step on a (1, 1) mesh over NCCL
    against the unsharded step, both on the card from the same seeded
    weights and batch; then ``entry()`` and ``dryrun_multichip(1)`` on the
    card."""
    import copy

    import numpy as np
    import torch

    from dynslam_tpu_torch.entry import dryrun_multichip, entry
    from dynslam_tpu_torch.models import dispnet
    from dynslam_tpu_torch.parallel import launch, sharding

    base = seeded_dispnet(config, SEED + 1)
    data = dispnet_data(config, frames, device)
    batch = {k: v[:DISP_BATCH] for k, v in data.items()}
    with launch.group(1, 0, device) as dev:
        mesh = sharding.make_mesh(1, 1, dev)
        one = copy.deepcopy(base).to(dev)
        step = dispnet.make_train_step(
            one, torch.optim.Adam(one.parameters(), lr=DISP_LR))
        sharded = sharding.shard_params(mesh, base)
        sstep = sharding.make_sharded_train_step(
            mesh, sharded, torch.optim.Adam(sharded.parameters(), lr=DISP_LR))
        local = sharding.shard_batch(mesh, batch)
        want = [float(step(batch)) for _ in range(SHARD_STEPS)]
        got = [float(sstep(local)) for _ in range(SHARD_STEPS)]
        params = sharding.gather_params(mesh, sharded)
        backend = torch.distributed.get_backend()
    diff = torch.cat([(params[k] - v).abs().flatten()
                      for k, v in one.state_dict().items()]).cpu().numpy()
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if rel > SHARD_LOSS_RTOL or diff.max() > 2 * DISP_LR * SHARD_STEPS \
            or np.median(diff) > SHARD_PARAM_MEDIAN:
        raise AssertionError(f"sharded step vs unsharded: losses {got} vs "
                             f"{want}, params max |d| {diff.max()}, median "
                             f"{np.median(diff)}")
    fn, args = entry(device)
    _, depth = fn(*args)
    hit = float((depth > 0).float().mean())
    if not hit > 0.5:
        raise AssertionError(f"entry(): hit fraction {hit}")
    dryrun_multichip(1, device)  # raises on a failed check; prints its line
    return dict(backend=backend, losses=got, rel=rel, max_diff=diff.max(),
                median_diff=float(np.median(diff)), entry_hit=hit)


def sequence_frames(frames, idx, device) -> dict:
    """Time-major (T, S, ...) stacks of the static frames ``idx`` (T, S),
    with their ground-truth depth and poses."""
    import numpy as np
    import torch

    poses = frames["poses"][idx]
    return dict(
        rgb=torch.tensor(np.repeat(frames["left"][idx][..., None], 3, -1),
                         device=device),
        depth=torch.tensor(frames["depth"][idx], device=device),
        cam_to_world=torch.tensor(poses, device=device),
        world_to_cam=torch.tensor(np.linalg.inv(poses), device=device))


def check_batch_metrics(cfg, metrics, depth, what: str) -> dict:
    """JAX's test bounds on the last frame (``BE_MAX_ERR_M``, and
    ``BE_MIN_HIT`` of the pixels within the fusion range)."""
    import torch

    d = depth[-1]
    reach = ((d >= cfg.min_depth) & (d <= cfg.max_depth)).float().mean(
        (1, 2))
    last = metrics[-1]
    hit = last[:, -1]
    if not bool(torch.isfinite(metrics).all()) \
            or not bool((last[:, 0] < BE_MAX_ERR_M).all()) \
            or not bool((hit > BE_MIN_HIT * reach).all()):
        raise AssertionError(f"{what} metrics on the last frame "
                             f"{last.tolist()} (pixels within the fusion "
                             f"range {reach.tolist()})")
    return dict(last=last.tolist(), reach=reach.tolist())


def check_batch_eval(config, dconfig, frames, dyn_frames, device) -> dict:
    """17d: static and dynamic batch evaluation of ``BE_SEQ`` sequence maps
    at the bench configuration (the dynamic run with phase 8's car masks
    and the shipped object volumes): metrics, K1 launches a frame, the
    pools' bytes, sequence-frames a second, and sequence 0 against a
    one-sequence run. The static run's first ``integrate_many`` call (all
    maps) is recorded for 17e."""
    import dataclasses as dc

    import numpy as np
    import torch

    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.parallel import batch_eval
    from dynslam_tpu_torch.pipeline.mapping import (
        engine_config_from, instance_config_from,
    )

    cfg, icfg = engine_config_from(config), instance_config_from(dconfig)
    # sequence s is frames s..s+BE_FRAMES-1
    idx = np.arange(BE_FRAMES)[:, None] + np.arange(BE_SEQ)[None]
    fr = sequence_frames(frames, idx, device)
    seq_frames = BE_SEQ * BE_FRAMES

    def pool_bytes(*pools):
        return sum(getattr(p, f.name).nbytes for p in pools
                   for f in dc.fields(p))

    recorder = FusionRecorder(batch_eval.integrate_many)
    batch_eval.integrate_many = recorder
    try:
        states = batch_eval.stacked_states(cfg, BE_SEQ, device)
        reset_launches()
        (states, metrics), static_ms = timed_ms(
            lambda: batch_eval.make_batch_eval(cfg)(states, fr))
        static_k1 = launch_counts()["integrate"]
    finally:
        batch_eval.integrate_many = recorder.fn
    fr["obj_mask"] = torch.tensor(dyn_frames["objid"][idx] > 0, device=device)
    dyn_states = (batch_eval.stacked_states(cfg, BE_SEQ, device),
                  batch_eval.stacked_states(icfg, BE_SEQ, device))
    reset_launches()
    (dyn_states, dmetrics), dyn_ms = timed_ms(
        lambda: batch_eval.make_dynamic_batch_eval(cfg, icfg)(dyn_states, fr))
    dyn_k1 = launch_counts()["integrate"]
    if static_k1 != BE_FRAMES or dyn_k1 != 2 * BE_FRAMES:
        raise AssertionError(f"K1 launches: static {static_k1}, dynamic "
                             f"{dyn_k1} over {BE_FRAMES} frames (need 1 and "
                             "2 a frame)")
    st = check_batch_metrics(cfg, metrics, fr["depth"], "static")
    dy = check_batch_metrics(cfg, dmetrics, fr["depth"], "dynamic")
    # sequence 0 alone, through the one-sequence step
    one = tsdf.create_state(cfg, device)
    one_m = []
    for t in range(BE_FRAMES):
        one, m = batch_eval._fusion_eval_step(
            cfg, one, fr["rgb"][t, 0], fr["depth"][t, 0],
            fr["cam_to_world"][t, 0], fr["world_to_cam"][t, 0], t)
        one_m.append(torch.stack(m))
    for k in ("tsdf_w", "color", "block_coords", "valid"):
        if not torch.equal(getattr(one, k), getattr(states, k)[0]):
            raise AssertionError(f"sequence 0's {k} differs from the "
                                 "one-sequence run")
    gap = float((torch.stack(one_m) - metrics[:, 0]).abs().max())
    return dict(static=st, dynamic=dy, static_k1=static_k1, dyn_k1=dyn_k1,
                static_fps=seq_frames / (static_ms / 1e3),
                dyn_fps=seq_frames / (dyn_ms / 1e3),
                static_bytes=pool_bytes(states),
                dyn_bytes=pool_bytes(*dyn_states), gap=gap,
                blocks=[int(states.valid[s].sum()) for s in range(BE_SEQ)],
                dyn_err=dmetrics[-1, :, 1].tolist(), recorder=recorder)


def run_phase17(config, dconfig, frames, dyn_frames, device, flush,
                parent) -> dict:
    """Phase 17: the learned models, sharding at world size 1, batch
    evaluation of sequence maps and K1 on their pool. Returns 17e's
    times and the K1 launches of 17d's runs."""
    from dynslam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    dn = check_dispnet(config, frames, device)
    say("dispnet", f"DispNet-lite (widths 32, 64, 96, 128; max disparity "
                   f"{config.stereo.max_disparity}) from a seeded Flax-layout "
                   f"param set, {W}x{H}: the card vs a CPU copy (TF32 off) "
                   f"max |d disparity| {dn['err']:.3g} px (bound "
                   f"{DISP_FWD_ATOL}); inference {dn['infer_ms']:.3f} ms "
                   f"(batch 1); {DISP_STEPS} Adam steps (lr {DISP_LR}, batch "
                   f"{DISP_BATCH}, {dn['valid']:.3f} of the pixels valid) "
                   f"{dn['step_ms']:.3f} ms a step (median); loss "
                   f"{dn['losses'][0]:.3f} -> {dn['losses'][-1]:.3f} px, the "
                   f"last 5 at {dn['fall']:.3f} of the first (need < "
                   f"{DISP_MAX_LOSS_FALL})")
    sn = check_segnet(dyn_frames, device, cuda_build.BUILD_DIR)
    say("segnet", f"SegNet-lite (widths 24, 48, 96) trained {SEG_STEPS} Adam "
                  f"steps (lr {SEG_LR}, batch {SEG_BATCH}) on dynamic frames "
                  f"0-{sn['held_out'] - 1}: {sn['step_ms']:.3f} ms a step "
                  f"(median), loss {sn['losses'][0]:.4f} -> "
                  f"{sn['losses'][-1]:.4f}; on held-out frame "
                  f"{sn['held_out']} the provider gives "
                  f"{sn['detections']} detections in {sn['frame_ms']:.2f} ms "
                  f"a frame, (truth covered, IoU) of the cars they hit "
                  f"{[(round(a, 3), round(b, 3)) for a, b in sn['found']]} "
                  f"(need one IoU > {MIN_CAR_IOU}); a CPU copy gives "
                  f"the same boxes {sn['boxes']}, masks {sn['agree']:.5f} "
                  f"equal; params file {sn['bytes']} bytes round-trips")
    sh = check_sharding(config, frames, device)
    say("sharding", f"sharded step on a (data 1, model 1) mesh over "
                    f"{sh['backend']} vs the unsharded step, {SHARD_STEPS} "
                    f"Adam steps at {W}x{H}: losses {sh['losses']} (rel "
                    f"{sh['rel']:.3g}), params max |d| {sh['max_diff']:.3g}, "
                    f"median {sh['median_diff']:.3g}; entry() on the card "
                    f"hit {sh['entry_hit']:.3f}; dryrun_multichip(1) printed "
                    "its line above")
    be = check_batch_eval(config, dconfig, frames, dyn_frames, device)
    say("batch-eval", f"{BE_SEQ} sequence maps x {BE_FRAMES} frames at the "
                      f"bench configuration: K1 launches {be['static_k1']} "
                      f"static, {be['dyn_k1']} dynamic (1 and 2 a frame); "
                      f"pools {be['static_bytes'] / 2 ** 30:.3f} GiB static, "
                      f"{be['dyn_bytes'] / 2 ** 30:.3f} GiB dynamic; "
                      f"{be['static_fps']:.2f} sequence-frames/s static, "
                      f"{be['dyn_fps']:.2f} dynamic (dense tracer renders); "
                      f"blocks a map {be['blocks']}; last frame (|error| m, "
                      f"hit) {be['static']['last']}, dynamic (unified, "
                      f"coverage) {be['dynamic']['last']} of "
                      f"{be['static']['reach']} within the fusion range; "
                      f"sequence 0 equals its one-sequence run (metrics gap "
                      f"{be['gap']:.3g})")
    k1s = check_integrate_many(be["recorder"].best, flush, parent)
    say("K1-seq", f"integrate_many over {len(k1s['vols'])} sequence maps "
                  f"({k1s['blocks']} visible blocks, {k1s['pixels']} distinct"
                  f" pixels read) vs integrate_ref per map: "
                  f"{k1s['exact'] * 100:.4f}% words bit-exact (worst map; "
                  f"need >= {K1_MIN_EXACT * 100:.2f}%), max |dsdf| "
                  f"{k1s['max_abs_err']:.3g}, |dw| {k1s['dw']} q, |dcolor| "
                  f"{k1s['dcolor']}")
    say("K1-seq", timing_text(k1s))
    say("phase17", f"{time.perf_counter() - t0:.1f} s")
    return dict(k1s=k1s, launches=be["static_k1"] + be["dyn_k1"])


# ---------------------------------------------------------------------------
# phase 18: the native readers, the soaks, the oversize fallback, the VO
# gauge and the dynamic step's profile
# ---------------------------------------------------------------------------

#: the soaks' lap (a shuttle: 10 frames forward along the corridor, 10
#: back), their laps (the FPS check compares lap 2 with the last) and the
#: decay age (the decay-gate recipe's 200 lowered so that decay runs)
SOAK_LAP, SOAK_LAPS, SOAK_DECAY_AGE = 20, 3, 10
#: vo_drift at its defaults: frames, size, focal length, speed, yaw
VO_FRAMES, VO_W, VO_H, VO_F, VO_SPEED, VO_YAW = 100, 320, 96, 260.0, 0.5, \
    0.002
#: 18a's split runs, numpy twins and native readers in turns
READER_TURNS = ("numpy", "native", "native", "numpy")
FALLBACK_REPS, PROFILE_WARMUP = 6, 3


@contextlib.contextmanager
def reader_mode(mode: str):
    """The staged readers' parsers within the block: ``native`` or the
    numpy twins (``DYNSLAM_NO_NATIVE_BUILD`` set)."""
    from dynslam_tpu_torch import native

    old = os.environ.pop(native.SWITCH, None)
    if mode == "numpy":
        os.environ[native.SWITCH] = "1"
    try:
        yield
    finally:
        os.environ.pop(native.SWITCH, None)
        if old is not None:
            os.environ[native.SWITCH] = old


def check_native_reads(seq: Path, depth) -> dict:
    """18a: every MNC mask, velodyne scan and PNG of phase 13's folder, and
    a PFM of ``depth`` written by ``write_pfm``, read through the staged
    readers with the native parsers and with their numpy twins: the
    arrays must be equal (dtype, shape and bytes). Returns the files read
    and each side's seconds."""
    from dynslam_tpu_torch.io import images
    from dynslam_tpu_torch.io.segmentation import (
        PrecomputedSegmentationProvider,
    )
    from dynslam_tpu_torch.io.velodyne import VelodyneIO
    from dynslam_tpu_torch.utils import pfm

    reads = []
    for res in sorted((seq / "seg_image_2" / "mnc").glob("*.result.txt")):
        x0, y0, x1, y1 = (int(float(v)) for v in res.read_text().split(
            "]")[0].strip("[").split()[:4])
        path = str(res).replace(".result.txt", ".mask.txt")
        reads.append(("mask", lambda p=path, w=x1 - x0 + 1, h=y1 - y0 + 1:
                      PrecomputedSegmentationProvider._read_mask(p, w, h)))
    lidar = VelodyneIO(str(seq / "velodyne"))
    for i in range(len(list((seq / "velodyne").glob("*.bin")))):
        reads.append(("velodyne", lambda i=i: lidar.read_frame(i)))
    for png in sorted(seq.glob("image_[23]/*.png")):
        reads.append(("png", lambda p=str(png): images.read_png(p)))
    pfm_path = str(seq.parent / "check.pfm")
    pfm.write_pfm(pfm_path, depth)
    reads.append(("pfm", lambda: pfm.read_pfm(pfm_path)))
    got, seconds = {}, {}
    for mode in ("numpy", "native"):
        with reader_mode(mode):
            t0 = time.perf_counter()
            got[mode] = [fn() for _, fn in reads]
            seconds[mode] = time.perf_counter() - t0
    for (kind, _), a, b in zip(reads, got["native"], got["numpy"]):
        if a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            raise AssertionError(f"native {kind} read differs from its "
                                 f"numpy twin: {a.shape} {a.dtype} / "
                                 f"{b.shape} {b.dtype}")
    return dict(counts=Counter(k for k, _ in reads), seconds=seconds)


def check_reader_runs(base, sdir: Path) -> dict:
    """18a: phase 16a's ``--prefetch`` split run with the numpy twins and
    with the native readers, in turns (``READER_TURNS``): the trajectory
    and CSVs byte for byte equal; each mode's mean ``1-read-input``,
    ``2-segmentation`` and frame total (ms a frame over the turns)."""
    import filecmp

    stages = ("1-read-input", "2-segmentation", "0-total-frame")
    ms = {m: {k: [] for k in stages} for m in set(READER_TURNS)}
    outs = []
    for turn, mode in enumerate(READER_TURNS):
        out = sdir / f"out_readers_{turn}"
        with reader_mode(mode):
            p = run_cli(base + ["--out", out, "--frame_limit", STAGED_SPLIT,
                                "--enable_evaluation", "--prefetch"])
        for k in stages:
            ms[mode][k].append(p.dyn._timers.mean_ms(k))
        outs.append(out)
    files = ["trajectory.txt"] + [f"csv/{n}" for n in
                                  sorted(os.listdir(outs[0] / "csv"))]
    differ = [(t, f) for t, o in enumerate(outs[1:], 1) for f in files
              if not filecmp.cmp(outs[0] / f, o / f, shallow=False)]
    if differ:
        raise AssertionError(f"reader runs differ from turn 0: {differ}")
    return dict(files=files, ms={m: {k: statistics.mean(v)
                                     for k, v in d.items()}
                                 for m, d in ms.items()})


def soak_scene(cfg, pipe, loop, k: int) -> dict:
    """The static soak's map at its last frame (the lap's frame ``k``),
    as ``map_scene`` gives a map: state, a grid rebuilt for the window,
    the visible blocks of the last pose, that frame's colour and stereo
    depth."""
    import torch

    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.utils.se3 import inverse

    c = pipe.carry
    grid = tsdf.build_local_grid(cfg, c.state, c.origin)
    slots, mask = tsdf.visible_blocks(cfg, c.state, grid, c.origin,
                                      c.pose_w2c)
    gray = torch.tensor(loop["left"][k], device=c.state.device)
    rgb = gray[..., None].expand(*gray.shape, 3).contiguous()
    return dict(state=c.state, grid=grid, origin=c.origin, slots=slots,
                mask=mask, rgb=rgb, depth=pipe.last_outputs.depth_m,
                w2c=c.pose_w2c, c2w=inverse(c.pose_w2c),
                frame=c.frame_idx)


def run_soaks(s_loop, d_loop, device, flush) -> dict:
    """18b and 18c: the static and dynamic soaks (``scripts/soak.py``) at
    1242x375 over ``SOAK_LAPS`` laps, their contracts, and the kernels at
    the static soak's last map and on the dynamic soak's largest routed
    volume fusion against their plain versions."""
    from dynslam_tpu_torch.config import InstanceMapParams
    from dynslam_tpu_torch.pipeline import fused_dynamic
    from dynslam_tpu_torch.pipeline.builder import engine_config_from
    from dynslam_tpu_torch.scripts import soak

    n = SOAK_LAP * SOAK_LAPS

    def log(msg):
        say("soak", msg.removeprefix("[soak] "))

    scfg = soak.soak_config(W, H, False, min_decay_age=SOAK_DECAY_AGE)
    reset_launches()
    res = soak.run_static(scfg, s_loop, n, device, seed=SEED, log=log)
    launches = launch_counts()
    msgs = soak.check_static(scfg, res, n, SOAK_LAP)
    if msgs:
        raise AssertionError(f"static soak: {msgs}")
    cfg = engine_config_from(scfg)
    scene = soak_scene(cfg, res["pipe"], s_loop, (n - 1) % SOAK_LAP)
    k1 = check_integrate(cfg, scene, flush)
    # the plain march takes ~10 s at this map: one timed call
    k2 = check_raycast(cfg, scene, flush, plain_reps=1)
    static = dict(laps=res["laps"], launches=launches, k1=k1, k2=k2,
                  fused=n - 1)
    del res, scene

    dcfg = soak.soak_config(W, H, True, min_decay_age=SOAK_DECAY_AGE,
                            instance_map=InstanceMapParams())
    recorder = FusionRecorder(fused_dynamic.integrate_many)
    fused_dynamic.integrate_many = recorder
    reset_launches()
    try:
        dres = soak.run_dynamic(dcfg, d_loop, n, device, seed=SEED, log=log)
    finally:
        fused_dynamic.integrate_many = recorder.fn
    dlaunches = launch_counts()
    msgs = soak.check_dynamic(dcfg, dres, SOAK_LAP)
    if msgs:
        raise AssertionError(f"dynamic soak: {msgs}")
    k1v = check_integrate_many(recorder.best, flush)
    return dict(static=static, dynamic=dict(
        laps=dres["laps"], launches=dlaunches, volume_calls=recorder.calls,
        k1=k1v, free=dres["free_series"], S=dres["pipe"].S,
        dispatches=dres["pipe"].current_frame_no - 1))


def run_fallback(device, flush) -> dict:
    """18d: ``measure_fallback``'s reps at bench.py's dynamic
    configuration; K1 of the call over the last rep's slot against
    ``integrate_ref``."""
    from dynslam_tpu_torch.pipeline import fused_dynamic
    from dynslam_tpu_torch.scripts import measure_fallback

    recorder = FusionRecorder(fused_dynamic.integrate_many)
    fused_dynamic.integrate_many = recorder
    reset_launches()
    try:
        res = measure_fallback.measure(
            bench_config(True), FALLBACK_REPS, device,
            log=lambda m: say("fallback", m.removeprefix("[measure] ")))
    finally:
        fused_dynamic.integrate_many = recorder.fn
    launches = launch_counts()["integrate"]
    if launches != FALLBACK_REPS or recorder.calls != FALLBACK_REPS:
        raise AssertionError(f"fallback: {launches} K1 launches in "
                             f"{FALLBACK_REPS} reps")
    return dict(times=res["times"], launches=launches,
                k1=check_integrate_many(recorder.best, flush))


def run_phase18(base, sdir: Path, dyn_frames, s_loop, d_loop, vo_seq,
                device, flush) -> dict:
    """Phase 18 (see the module docstring); returns what the kernels line
    reports."""
    from dynslam_tpu_torch.native import build as native_build
    from dynslam_tpu_torch.scripts import profile_dynamic, vo_drift

    # 18a. the native readers
    t0 = time.perf_counter()
    reads = check_native_reads(sdir / "seq", dyn_frames["depth"][0])
    say("native", f"{dict(reads['counts'])} files of phase 13's folder and "
                  f"a write_pfm file: native parsers equal to their numpy "
                  f"twins byte for byte; {reads['seconds']['native']:.3f} s "
                  f"native, {reads['seconds']['numpy']:.3f} s numpy")
    rr = check_reader_runs(base, sdir)
    for mode, m in sorted(rr["ms"].items()):
        say("native", f"--prefetch split run, {mode} readers (mean of "
                      f"{READER_TURNS.count(mode)} turns of "
                      f"{READER_TURNS}): 1-read-input "
                      f"{m['1-read-input']:.2f} ms, 2-segmentation "
                      f"{m['2-segmentation']:.2f} ms, frame total "
                      f"{m['0-total-frame']:.2f} ms")
    say("native", f"{', '.join(rr['files'])} byte-identical across the "
                  f"turns; 18a in {time.perf_counter() - t0:.1f} s; library "
                  f"{native_build.library_path().name}")

    # 18b and 18c. the soaks
    t0 = time.perf_counter()
    soaks = run_soaks(s_loop, d_loop, device, flush)
    st, dy = soaks["static"], soaks["dynamic"]
    say("soak", f"static: launches {st['launches']} over {st['fused']} fused"
                f" frames; FPS by lap "
                f"{[round(x['fps'], 2) for x in st['laps']]}, used blocks "
                f"{[x['used'] for x in st['laps']]}, visible "
                f"{[x['visible'] for x in st['laps']]}, decayed "
                f"{[x['decayed'] for x in st['laps']]}, host syncs a frame "
                f"{[round(x['syncs'], 2) for x in st['laps']]}; the soak's "
                f"contract holds")
    for tag, r in (("K1-soak", st["k1"]), ("K2-soak-pre", st["k2"]["pre"]),
                   ("K2-soak", st["k2"])):
        say(tag, timing_text(r))
    say("K1-soak", f"at the last lap's map: {st['k1']['blocks']} visible "
                   f"blocks, {st['k1']['exact'] * 100:.4f}% words bit-exact;"
                   f" K2 hit agreement {st['k2']['agree'] * 100:.4f}%, "
                   f"pre-pass bitmap equal ({st['k2']['pre']['n_cand']} "
                   f"candidate cells)")
    say("soak", f"dynamic: launches {dy['launches']} over "
                f"{dy['dispatches']} dispatches ({dy['volume_calls']} with "
                f"routed volumes); FPS by lap "
                f"{[round(x['fps'], 2) for x in dy['laps']]}, live objects "
                f"{[x['live_objects'] for x in dy['laps']]}, tracks ever "
                f"{[x['tracks_created'] for x in dy['laps']]}, active "
                f"{[x['active_tracks'] for x in dy['laps']]}, fewest free "
                f"slots {min(dy['free'])}/{dy['S']}, host syncs a frame "
                f"{[round(x['syncs'], 2) for x in dy['laps']]}; the "
                f"dynamic contract holds; 18b-c in "
                f"{time.perf_counter() - t0:.1f} s")
    say("K1-soak-vol", f"integrate_many over {len(dy['k1']['vols'])} "
                       f"volumes ({dy['k1']['blocks']} blocks): "
                       f"{dy['k1']['exact'] * 100:.4f}% words bit-exact; "
                       + timing_text(dy["k1"]))

    # 18d. the oversize fallback
    fb = run_fallback(device, flush)
    med = {k: statistics.median(t[k] for t in fb["times"][1:])
           for k in ("host_ms", "upload_ms", "run_ms")}
    say("fallback", f"{FALLBACK_REPS} reps of fuse_slot_fullframe (median "
                    f"of reps 1-{FALLBACK_REPS - 1}): host prep "
                    f"{med['host_ms']:.2f} ms, upload {med['upload_ms']:.2f} "
                    f"ms, dispatch+run {med['run_ms']:.2f} ms; K1 "
                    f"{fb['k1']['exact'] * 100:.4f}% words bit-exact on "
                    f"{fb['k1']['blocks']} blocks; " + timing_text(fb["k1"]))

    # 18e. the VO gauge and the dynamic step's profile
    t0 = time.perf_counter()
    vo = vo_drift.drift(vo_seq, VO_W, VO_H, VO_F, device)
    if not (abs(vo["drift_pct"]) <= vo_drift.MAX_DRIFT_PCT
            and vo["rmse"] <= vo_drift.MAX_RMSE_M):
        raise AssertionError(f"vo_drift: {vo}")
    say("vo", f"vo_drift, {vo['frames']} frames {VO_W}x{VO_H} f {VO_F}: "
              f"median scale drift {vo['drift_pct']:+.3f} %/frame (need "
              f"|.| <= {vo_drift.MAX_DRIFT_PCT}), RMSE {vo['rmse']:.3f} m "
              f"(need <= {vo_drift.MAX_RMSE_M}), final error "
              f"{vo['final_err']:.3f} m over {vo['path']:.1f} m, in "
              f"{time.perf_counter() - t0:.1f} s")
    dconfig = bench_config(True, min_decay_age=MIN_DECAY_AGE)
    prof = profile_dynamic.profile(
        dconfig, dyn_frames["left"], dyn_frames["right"],
        [frame_detections(o) for o in dyn_frames["objid"]], PROFILE_WARMUP,
        BUILD_DIR / "profile_dynamic", device, tag="profile_dynamic")
    say("profile_dynamic", f"every stage of {profile_dynamic.STAGES} ran "
                           f"over frames {PROFILE_WARMUP + 1}-{N_DYN - 1}")
    return dict(soaks=soaks, fallback=fb, vo=vo, profile=prof)


# ---------------------------------------------------------------------------


def build_kernels(parent: Optional[Path]) -> dict:
    """Phase 2: every kernel source with nvcc, one process each, and the
    native readers (``native/fastio.cpp``) with g++, all started
    together; with ``parent`` (a checkout of the parent commit) also the
    parent's two kernels. Checks that this tree's libraries have its C
    ABI. Returns the parent's library paths (empty without ``parent``)."""
    from concurrent.futures import ThreadPoolExecutor

    from dynslam_tpu_torch.native import build as native_build
    from dynslam_tpu_torch.ops import cuda_build

    jobs = [(name, "", cuda_build.CSRC_DIR) for name in KERNEL_SOURCES]
    if parent is not None:
        jobs += [(name, "parent ", parent / "dynslam_tpu_torch" / "csrc")
                 for name in KERNEL_SOURCES]
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        native = ex.submit(native_build.build)
        built = list(ex.map(lambda j: cuda_build.build(j[0], j[2]), jobs))
        path, seconds = native.result()
    say("build", f"native readers (g++): {seconds:.2f} s -> {path.name}")
    libs = {}
    for (name, tag, _), b in zip(jobs, built):
        regs = [ln.split("ptxas info    : ")[-1] for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln]
        abi = cuda_build.abi_version(b.path)
        say("build", f"{tag}{name}: {b.seconds:.2f} s -> {b.path.name}, C "
                     f"ABI {abi}; {'; '.join(regs) or 'cached'}")
        if tag:
            libs[name] = b.path
        elif abi != cuda_build.ABI_VERSION:
            raise AssertionError(f"{name}: C ABI {abi}, the wrappers speak "
                                 f"{cuda_build.ABI_VERSION}")
    return libs


def kernel_entry(name: str, src: dict, launches: int, per_frame: float,
                 r: dict) -> dict:
    """One entry of the kernels JSON line."""
    return dict(name=name, **src, launches=launches,
                max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None,
                kernel_ms=r["kernel_ms"], kernel_ms_cold=r["kernel_ms_cold"],
                wrapper_ms=r["wrapper_ms"],
                bound_share=r["bound_ms"] / r["kernel_ms"],
                bound_share_cold=r["bound_ms"] / r["kernel_ms_cold"],
                parent_kernel_ms=r["parent_kernel_ms"],
                parent_kernel_ms_cold=r["parent_kernel_ms_cold"],
                launches_per_frame=per_frame)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: its kernels are "
                         "built and timed beside these on the same inputs")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 1
    if not (PACKAGE / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found; run from a checkout of "
              "the repository", file=sys.stderr)
        return 1
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
    parent = build_kernels(args.parent)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=device)

    config = bench_config(False, min_decay_age=MIN_DECAY_AGE)
    cfg = engine_config_from(config)
    # every frame the script drives, rendered in one pool: the bench
    # scenes, the soaks' laps (phase 18b-c) and vo_drift's gauge (18e)
    from dynslam_tpu_torch.scripts import soak, vo_drift

    t0 = time.perf_counter()
    s_set, s_idx = soak.loop_set(SOAK_LAP, W, H, False, "shuttle")
    d_set, d_idx = soak.loop_set(SOAK_LAP, W, H, True, "shuttle")
    frames, dyn_frames, s_loop, d_loop, vo_seq = render_sets(
        bench_sets(config, [(N_FRAMES, False), (N_DYN, True)])
        + [s_set, d_set, vo_drift.sequence_set(VO_FRAMES, VO_W, VO_H, VO_F,
                                               VO_SPEED, VO_YAW)],
        BUILD_DIR)
    s_loop, d_loop = soak.lap_frames(s_loop, s_idx), \
        soak.lap_frames(d_loop, d_idx)
    say("frames", f"{N_FRAMES} static and {N_DYN} dynamic frames {W}x{H} "
                  f"(bench scenes, seed {SEED}), the soaks' {SOAK_LAP}-frame"
                  f" laps ({len(s_set.poses)} and {len(d_set.poses)} "
                  f"renders) and {VO_FRAMES} vo_drift frames {VO_W}x{VO_H} "
                  f"in {time.perf_counter() - t0:.1f} s")

    # 3. K1 vs plain
    scene = map_scene(cfg, frames, device)
    k1 = check_integrate(cfg, scene, flush, parent)
    say("K1", f"integrate vs integrate_ref on {k1['blocks']} visible blocks "
              f"({k1['pixels']} distinct pixels read): "
              f"{k1['exact'] * 100:.4f}% words bit-exact (need >= "
              f"{K1_MIN_EXACT * 100:.2f}%), max |dsdf| {k1['max_abs_err']:.3g}"
              f", |dw| {k1['dw']} q, |dcolor| {k1['dcolor']}")
    say("K1", timing_text(k1))

    # 4. the pre-pass and K2 vs plain
    k2 = check_raycast(cfg, scene, flush, parent)
    pre = k2["pre"]
    say("K2-pre", f"candidate bitmap of the {cfg.local_dims} window equals "
                  f"candidate_bits_ref exactly ({pre['n_cand']} candidate "
                  f"cells of {pre['n_live']} visible blocks)")
    say("K2-pre", timing_text(pre))
    say("K2", f"raycast vs raycast_ref at {W}x{H}: hit agreement "
              f"{k2['agree'] * 100:.4f}%, median |ddepth| {k2['median']:.3g}"
              f" m, max {k2['max_abs_err']:.3g} m, points/colour/weight "
              f"equal on {k2['epi_agree'] * 100:.4f}% of equal-depth pixels,"
              f" hit {k2['hit']:.3f}, median |depth - gt| "
              f"{k2['gt_err']:.4f} m, {k2['samples']} samples (plain "
              f"{k2['ref_samples']}); {reads_text(k2['reads'])}")
    say("K2", timing_text(k2))

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
    prof = profile_frames(
        lambda: [res["pipe"].process_frame(lgs[j], rgs[j], rgbs[j])
                 for j in range(N_FRAMES - 2, N_FRAMES)],
        2, cuda_build.BUILD_DIR)
    _, _, rc_kernels, rc_memsets = prof["stages"]["fused_step.raycast"]
    if rc_kernels + rc_memsets > RAYCAST_STAGE_MAX_LAUNCHES:
        raise AssertionError(
            f"raycast stage: {rc_kernels:.0f} launches and {rc_memsets:.0f} "
            f"memsets a frame (at most {RAYCAST_STAGE_MAX_LAUNCHES} in all)")
    say("profile", f"raycast stage {rc_kernels:.0f} launches and "
                   f"{rc_memsets:.0f} memsets a frame (at most "
                   f"{RAYCAST_STAGE_MAX_LAUNCHES} in all)")
    del res, scene

    # 8. the dynamic slice (its routed fusions feed phase 7)
    dconfig = bench_config(True, min_decay_age=MIN_DECAY_AGE)
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
    _, _, rc_kernels, rc_memsets = \
        dres["profile"]["stages"]["fused_step.raycast"]
    say("dyn", f"raycast stage {rc_kernels:.0f} launches and "
               f"{rc_memsets:.0f} memsets a frame")

    # 7. K1's volume axis vs plain, on phase 8's largest routed fusion
    k1v = check_integrate_many(dres["recorder"].best, flush, parent)
    say("K1-vol", f"integrate_many over {len(k1v['vols'])} object volumes "
                  f"{k1v['vols']} ({k1v['blocks']} visible blocks, "
                  f"{k1v['pixels']} distinct pixels read) vs "
                  f"integrate_ref per volume: {k1v['exact'] * 100:.4f}% "
                  f"words bit-exact (worst volume; need >= "
                  f"{K1_MIN_EXACT * 100:.2f}%), max |dsdf| "
                  f"{k1v['max_abs_err']:.3g}, |dw| {k1v['dw']} q, |dcolor| "
                  f"{k1v['dcolor']}")
    say("K1-vol", timing_text(k1v))

    # 9. the pre-pass and K2 on one object volume vs plain
    k2o = check_instance_raycast(pipe, dyn["track"], dyn_frames, flush,
                                 parent)
    opre = k2o["pre"]
    say("K2-obj-pre", f"candidate bitmap of the {pipe.icfg.local_dims} "
                      f"window equals candidate_bits_ref exactly "
                      f"({opre['n_cand']} candidate cells of "
                      f"{opre['n_live']} visible blocks)")
    say("K2-obj-pre", timing_text(opre))
    say("K2-obj", f"raycast_instance of track {k2o['track']} from its frame "
                  f"{k2o['frame']} camera vs raycast_ref at {W}x{H}: hit "
                  f"agreement {k2o['agree'] * 100:.4f}%, median |ddepth| "
                  f"{k2o['median']:.3g} m, max {k2o['max_abs_err']:.3g} m, "
                  f"points/colour/weight equal on "
                  f"{k2o['epi_agree'] * 100:.4f}% of equal-depth pixels, "
                  f"{k2o['hits']} hits; on {k2o['car_px']} car pixels median "
                  f"|depth - gt| {k2o['gt_err']:.4f} m (median signed "
                  f"{k2o['gt_bias']:+.4f}), the frame's stereo depth "
                  f"{k2o['stereo_err']:.4f} m ({k2o['stereo_bias']:+.4f}); "
                  f"{k2o['samples']} samples (plain {k2o['ref_samples']}); "
                  f"{reads_text(k2o['reads'])}")
    say("K2-obj", timing_text(k2o))

    # 10. the static slice with evaluation on
    eval_dir = cuda_build.BUILD_DIR / "smoke_eval"
    pts = write_lidar(config, frames, eval_dir / "static")
    say("eval", f"build_fused_static as in phase 5 with FusedEvaluation "
                f"attached, {N_FRAMES} frames submitted as main.run_fused "
                f"does; LIDAR ground truth every {LIDAR_STRIDE}nd pixel of "
                f"the rendered depth, {pts:.0f} points a scan")
    # evaluation off and on in turns (off, on, on, off), all after the
    # profiled phases: frame rates are compared only within such turns
    fps, last = dict(on=[], off=[]), {}
    for mode in ("off", "on", "on", "off"):
        r = run_slice(dataclasses.replace(config, dynamic_mode=False),
                      frames, device, tag=f"eval-{mode}",
                      eval_root=eval_dir / "static" if mode == "on" else None)
        fps[mode].append(check_slice(r, N_FRAMES, config)["fps"])
        last[mode] = r
    eres, ecensus = last["on"], last["off"]["census"]
    del last
    sev = check_static_eval(eres, dict(census=ecensus), config)
    cost = eval_job_cost(eres["pipe"].evaluation, N_FRAMES - 1,
                         eres["pipe"].last_outputs, cuda_build.BUILD_DIR)
    say("eval", f"CSVs {sorted(sev['files'])} under base_csv_name's names; "
                f"unified rows for frames 1-{N_FRAMES - 1}; KITTI-rule "
                f"correct share "
                f"{ {f: round(s, 4) for f, s in sev['shares'].items()} } "
                f"(need >= {MIN_KITTI_CORRECT} from frame 2); host syncs on "
                f"the frame thread in frame {CENSUS_FRAME}: {sev['syncs']} "
                f"(eval off, same phase: {sum(ecensus.values())}; the same "
                f"sites), the worker's: "
                f"{dict(eres['worker_census'].most_common())}")
    say("eval", f"FPS over the last {FPS_FRAMES} frames, in turns off, "
                f"on, on, off: evaluation on "
                f"{[round(x, 2) for x in fps['on']]}, off "
                f"{[round(x, 2) for x in fps['off']]} (phase 5, before the "
                f"profiled phases: {sl['fps']:.2f}); the "
                f"worker's wall ms a job median "
                f"{statistics.median(sev['job_ms']):.2f}, max "
                f"{max(sev['job_ms']):.2f} ({len(sev['job_ms'])} jobs: scan "
                f"read, upload, eval, fetch, sharing the interpreter with "
                f"the frame thread); one job alone: "
                f"{cost['wall_ms']:.2f} ms wall, {cost['kernels']} kernel "
                f"launches, {cost['memsets']} memsets and {cost['copies']} "
                f"copies; the eval's device time "
                f"{cost['device_ms']:.4f} ms on {cost['points']} points")

    # 11. the dynamic slice with evaluation on
    dpts = write_lidar(dconfig, dyn_frames, eval_dir / "dynamic")
    say("dyn-eval", f"build_fused_dynamic as in phase 8 with FusedEvaluation "
                    f"attached, {N_DYN} frames, dispatch_lag 2, then finalize"
                    f" and close; {dpts:.0f} LIDAR points a scan")
    # in turns with evaluation off; the last of each is profiled (frames
    # 10-11, after the frames the rate is taken over)
    dfps, dprof = dict(on=[], off=[]), {}
    for turn, mode in enumerate(("on", "off", "off", "on")):
        on = mode == "on"
        r = run_dynamic(dconfig, dyn_frames, device, cuda_build.BUILD_DIR,
                        eval_root=eval_dir / "dynamic" if on else None,
                        census_frames=DYN_EVAL_CENSUS_FRAMES,
                        profile=turn >= 2, tag=f"dyn-eval-{mode}")
        if r["profile"] is not None:
            dprof[mode] = r["profile"]
        if turn == 0:
            djob_ms = list(r["pipe"].evaluation.job_ms)
        ms = [r["times"][i] for i in DYN_FPS_FRAMES]
        dfps[mode].append(len(ms) / (sum(ms) / 1e3))
        if on:
            deres = r
        else:
            doff = r
    dev_ = check_dynamic_eval(deres, doff)
    del doff
    dpipe, ddisp = deres["pipe"], deres["dispatches"]
    say("dyn-eval", f"launches {deres['launches']} over {ddisp} dispatches: "
                    f"{dpipe.eval_crop_renders} crop-viewport and "
                    f"{dpipe.eval_full_renders} full-frame object renders for"
                    f" the evaluation ({dpipe.eval_crop_renders / ddisp:.2f}"
                    f" and {dpipe.eval_full_renders / ddisp:.2f} a frame), "
                    f"{deres['rendered']} in composited_preview; dynamic "
                    f"bucket {dev_['total']} points over the run, "
                    f"{dev_['hit']} with a fused depth; up to "
                    f"{dev_['recon']} reconstructed tracks, 0 dropped "
                    f"detections; KITTI-rule correct share (unified) "
                    f"{[round(s, 4) for s in dev_['shares']]}")
    say("dyn-eval", f"FPS over frames {DYN_FPS_FRAMES.start}-"
                    f"{DYN_FPS_FRAMES.stop - 1}, in turns on, off, off, on: "
                    f"evaluation on {[round(x, 2) for x in dfps['on']]}, off "
                    f"{[round(x, 2) for x in dfps['off']]} (phase 8: "
                    f"{dyn['fps']:.2f}); the last turn "
                    f"{', '.join(f'{m:.1f}' for m in dev_['ms'])} ms; host "
                    f"syncs on the frame thread by frame {dev_['syncs']} "
                    f"(equal, site by site, to an eval-off turn's); the "
                    f"worker's wall ms a job "
                    f"in the first turn: median "
                    f"{statistics.median(djob_ms):.2f}, max "
                    f"{max(djob_ms):.2f} ({len(djob_ms)} jobs)")

    # 12. the pre-pass and K2 in the crop viewport vs plain
    k2c = check_crop_raycast(dpipe, deres["crops"], flush, parent)
    cpre = k2c["pre"]
    say("K2-crop-pre", f"candidate bitmap of slot {k2c['slot']}'s "
                       f"{dpipe.icfg_render.local_dims} window "
                       f"({k2c['blocks']} blocks) from the crop viewport at "
                       f"(u0, v0) = ({k2c['u0']}, {k2c['v0']}) equals "
                       f"candidate_bits_ref exactly ({cpre['n_cand']} "
                       f"candidate cells of {cpre['n_live']} visible "
                       "blocks)")
    say("K2-crop-pre", timing_text(cpre))
    say("K2-crop", f"crop-viewport render "
                   f"{dpipe.icfg_render.height}x{dpipe.icfg_render.width} vs"
                   f" raycast_ref: hit agreement {k2c['agree'] * 100:.4f}%, "
                   f"median |ddepth| {k2c['median']:.3g} m, max "
                   f"{k2c['max_abs_err']:.3g} m, points/colour/weight equal "
                   f"on {k2c['epi_agree'] * 100:.4f}% of equal-depth pixels, "
                   f"{k2c['hits']} hits; at {k2c['edge_hw'][0]}x"
                   f"{k2c['edge_hw'][1]} (8x4 tiles cut at the edges): hit "
                   f"agreement {k2c['edge']['agree'] * 100:.4f}%, median "
                   f"|ddepth| {k2c['edge']['median']:.3g} m; "
                   f"{k2c['samples']} samples (plain {k2c['ref_samples']}); "
                   f"{reads_text(k2c['reads'])}")
    say("K2-crop", timing_text(k2c))

    # 13. the staged dynamic slice through the CLI
    sdir = cuda_build.BUILD_DIR / "smoke_staged"
    seq, out = sdir / "seq", sdir / "out"
    t0 = time.perf_counter()
    spts = write_staged_sequence(dconfig, dyn_frames, seq)
    base = ["--dataset_root", seq, "--min_decay_age", MIN_DECAY_AGE]
    say("staged", f"phase 8's {N_DYN} frames written as a KITTI-odometry "
                  f"folder in {time.perf_counter() - t0:.1f} s ({spts:.0f} "
                  f"LIDAR points a scan); dynslam_tpu_torch.main at "
                  f"DynSlamConfig() with --min_decay_age {MIN_DECAY_AGE} "
                  f"--enable_evaluation --evaluation_delay {STAGED_DELAY} "
                  f"--dump_previews_every {STAGED_PREVIEWS}")
    st = run_cli(base + ["--out", out, "--enable_evaluation",
                         "--evaluation_delay", STAGED_DELAY,
                         "--dump_previews_every", STAGED_PREVIEWS],
                 census_frame=STAGED_CENSUS_FRAME)
    stc = check_staged(st, dyn_frames, out)
    per = {f: (r["k1"], r["flushes"], r["catchup"], r["pre"], r["march"],
               r["renderable"]) for f, r in st.frames.items()}
    say("staged", f"launches {st.launches} ({st.recorder.calls} pool "
                  f"flushes, {st.pool_renders} pool-slot renders); per frame "
                  f"(K1, flushes, catch-up chain, K2 pre-pass, K2 march, "
                  f"renderable tracks) "
                  f"{per}; volumes {stc['recon']}; final pose error "
                  f"{stc['err'] * 100:.2f} cm over {stc['travelled']:.1f} m;"
                  f" static blocks {stc['blocks']}, 0 dropped; tinted "
                  f"preview pixels {st.tinted}; peak memory "
                  f"{st.peak_gb:.2f} GB")
    say("staged", f"CSVs {sorted(stc['files'])}, rows for frames 0-"
                  f"{N_DYN - 1 - STAGED_DELAY} (delay {STAGED_DELAY}); "
                  f"KITTI-rule correct share by bucket (delayed frames "
                  f"routed with the latest detections, as the reference "
                  f"routes them): " + "; ".join(
                      f"{b} {[round(v, 4) for v in sh.values()]}"
                      for b, sh in stc["shares"].items()))
    say("staged", f"{stc['fps']:.2f} FPS over frames {DYN_FPS_FRAMES.start}-"
                  f"{DYN_FPS_FRAMES.stop - 1} "
                  f"({', '.join(f'{m:.1f}' for m in stc['ms'])} ms); whole "
                  f"CLI run {st.wall_s:.1f} s; host syncs in frame "
                  f"{STAGED_CENSUS_FRAME}: {sum(st.census.values())} "
                  f"{dict(st.census.most_common())}")
    print(st.dyn.get_timing_report(), flush=True)
    ck = sdir / "split.npz"
    split = run_cli(base + ["--out", sdir / "out_split", "--frame_limit",
                            STAGED_SPLIT, "--checkpoint_out", ck,
                            "--enable_evaluation"])
    own = check_own_frame_eval(split)
    say("staged", f"split run, evaluation delay 0: KITTI-rule correct share "
                  f"by bucket " + "; ".join(
                      f"{b} {[round(v, 4) for v in sh.values()]}"
                      for b, sh in own.items())
        + f" (static: need >= {MIN_KITTI_CORRECT} from frame 2)")
    resumed = run_cli(base + ["--out", sdir / "out_resumed",
                              "--resume_from", ck])
    spl = check_split(st, resumed, out, sdir / "out_resumed")
    say("staged", f"split run: {len(split.frames)} frames, checkpoint, "
                  f"resumed for frames {spl['frames']}: trajectory prefix "
                  f"equal within {spl['gap']:.3g}, used blocks "
                  f"{spl['blocks'][1]} vs {spl['blocks'][0]} continuous "
                  f"(need within {SPLIT_BLOCKS_RTOL:.0%})")

    # 14. K1 on the pool flush vs plain
    k1p = check_integrate_many(st.recorder.best, flush, parent)
    say("K1-pool", f"pool flush over {len(k1p['vols'])} object volumes "
                   f"{k1p['vols']} at full frame ({k1p['blocks']} visible "
                   f"blocks, {k1p['pixels']} distinct pixels read) vs "
                   f"integrate_ref per volume: {k1p['exact'] * 100:.4f}% "
                   f"words bit-exact (worst volume; need >= "
                   f"{K1_MIN_EXACT * 100:.2f}%), max |dsdf| "
                   f"{k1p['max_abs_err']:.3g}, |dw| {k1p['dw']} q, |dcolor| "
                   f"{k1p['dcolor']}")
    say("K1-pool", timing_text(k1p))

    # 15. K2 at a free pose and on a pool slot vs plain
    eng = st.dyn.static_scene
    k2f = check_view_raycast(eng.cfg, eng.state, free_pose(eng.cam_to_world),
                             eng.intrinsics_vec, flush, parent,
                             "K2 at the free pose", min_hits=20_000)
    say("K2-free-pre", f"candidate bitmap at the free pose equals "
                       f"candidate_bits_ref exactly ({k2f['pre']['n_cand']} "
                       f"candidate cells of {k2f['pre']['n_live']} visible "
                       "blocks)")
    say("K2-free-pre", timing_text(k2f["pre"]))
    say("K2-free", f"static map 3 m up, 6 m back, 15 deg down vs raycast_ref"
                   f": hit agreement {k2f['agree'] * 100:.4f}%, median "
                   f"|ddepth| {k2f['median']:.3g} m, {k2f['hits']} hits; "
                   f"{reads_text(k2f['reads'])}")
    say("K2-free", timing_text(k2f))
    rec = st.dyn.instance_reconstructor
    track = max((t for t in rec.tracker.active_tracks.values()
                 if t.has_reconstruction()),
                key=lambda t: t.reconstruction.get_used_block_count())
    pool = rec.volume_pool
    k2s = check_view_raycast(
        pool.cfg, pool.slot_state(track.reconstruction.slot),
        rec._instance_render_pose(track, st.dyn.get_current_pose()),
        pool.intrinsics_vec, flush, parent, "K2 on a pool slot",
        min_hits=500)
    say("K2-slot-pre", f"candidate bitmap of slot {track.reconstruction.slot}"
                       f" (track {track.id}) equals candidate_bits_ref "
                       f"exactly ({k2s['pre']['n_cand']} candidate cells of "
                       f"{k2s['pre']['n_live']} visible blocks)")
    say("K2-slot-pre", timing_text(k2s["pre"]))
    say("K2-slot", f"pool slot at the composite's render pose vs raycast_ref"
                   f": hit agreement {k2s['agree'] * 100:.4f}%, median "
                   f"|ddepth| {k2s['median']:.3g} m, {k2s['hits']} hits; "
                   f"{reads_text(k2s['reads'])}")
    say("K2-slot", timing_text(k2s))

    # 16. the CLI's last outputs
    pre16, rb, overlay, rr = run_phase16(base, sdir, split, dyn_frames, dyn,
                                         k2f)

    # 17. the learned models, sharding, and batch evaluation
    p17 = run_phase17(config, dconfig, frames, dyn_frames, device, flush,
                      parent)

    # 18. the native readers, the soaks, the oversize fallback, the VO
    # gauge and the dynamic step's profile
    p18 = run_phase18(base, sdir, dyn_frames, s_loop, d_loop, vo_seq,
                      device, flush)

    k1_src = dict(route="cuda", source="dynslam_tpu_torch/csrc/integrate.cu",
                  replaces="dynslam_tpu/ops/pallas_integrate.py:536")
    k2_src = dict(route="cuda", source="dynslam_tpu_torch/csrc/raycast.cu",
                  replaces="dynslam_tpu/ops/pallas_raycast.py:600")
    # one entry per kernel and path: the static slice's launches with
    # phases 3-4's times, the dynamic slice's (static map, object volumes
    # and object renders) with phases 7 and 9's
    fused, disp = N_FRAMES - 1, dres["dispatches"]
    dl = dres["launches"]
    kernels = [
        kernel_entry("integrate", k1_src, static_launches["integrate"],
                     static_launches["integrate"] / fused, k1),
        kernel_entry("integrate/volume-axis", k1_src, dl["integrate"],
                     dl["integrate"] / disp, k1v),
        kernel_entry("raycast/candidates", k2_src,
                     static_launches["candidates"],
                     static_launches["candidates"] / fused, pre),
        kernel_entry("raycast", k2_src, static_launches["raycast"],
                     static_launches["raycast"] / fused, k2),
        kernel_entry("raycast/candidates-object-volume", k2_src,
                     dl["candidates"], dl["candidates"] / disp, opre),
        kernel_entry("raycast/object-volume", k2_src, dl["raycast"],
                     dl["raycast"] / disp, k2o),
        # phase 11's crop-viewport renders (one pre-pass and one march
        # each) with phase 12's times
        kernel_entry("raycast/candidates-crop-viewport", k2_src,
                     dpipe.eval_crop_renders,
                     dpipe.eval_crop_renders / ddisp, cpre),
        kernel_entry("raycast/crop-viewport", k2_src,
                     dpipe.eval_crop_renders,
                     dpipe.eval_crop_renders / ddisp, k2c),
    ]
    # phase 13's launches (the CLI run, previews included) by role, with
    # the times of phases 3, 14 and 15: the static map at one volume, the
    # pool flush, the static map's renders (prepare, the delayed
    # evaluation's past pose, previews) and the pool-slot renders
    sl, flushes, slot_r = st.launches, st.recorder.calls, st.pool_renders
    kernels += [
        kernel_entry("integrate/staged-static-map", k1_src,
                     sl["integrate"] - flushes,
                     (sl["integrate"] - flushes) / N_DYN, k1),
        kernel_entry("integrate/pool-flush", k1_src, flushes,
                     flushes / N_DYN, k1p),
        kernel_entry("raycast/candidates-staged-static-map", k2_src,
                     sl["candidates"] - slot_r,
                     (sl["candidates"] - slot_r) / N_DYN, k2f["pre"]),
        kernel_entry("raycast/staged-static-map", k2_src,
                     sl["raycast"] - slot_r,
                     (sl["raycast"] - slot_r) / N_DYN, k2f),
        kernel_entry("raycast/candidates-pool-slot", k2_src, slot_r,
                     slot_r / N_DYN, k2s["pre"]),
        kernel_entry("raycast/pool-slot", k2_src, slot_r, slot_r / N_DYN,
                     k2s),
    ]
    # phase 16's launches by role, with the times of phases 3 and 15: the
    # prefetching run (16a), the run with meshes and direct refinement
    # (16b) without its overlays, the overlays' object renders (pool
    # slots) and the renderer (16c)
    pl, bl, rl = pre16.launches, rb.launches, rr["launches"]
    n_ov = len(overlay.ms)
    kernels += [
        kernel_entry("integrate/staged-prefetch", k1_src, pl["integrate"],
                     pl["integrate"] / STAGED_SPLIT, k1),
        kernel_entry("raycast/candidates-staged-prefetch", k2_src,
                     pl["candidates"], pl["candidates"] / STAGED_SPLIT,
                     k2f["pre"]),
        kernel_entry("raycast/staged-prefetch", k2_src, pl["raycast"],
                     pl["raycast"] / STAGED_SPLIT, k2f),
        kernel_entry("integrate/staged-refine-mesh", k1_src, bl["integrate"],
                     bl["integrate"] / N_DYN, k1),
        kernel_entry("raycast/candidates-staged-refine-mesh", k2_src,
                     bl["candidates"] - overlay.pre,
                     (bl["candidates"] - overlay.pre) / N_DYN, k2f["pre"]),
        kernel_entry("raycast/staged-refine-mesh", k2_src,
                     bl["raycast"] - overlay.march,
                     (bl["raycast"] - overlay.march) / N_DYN, k2f),
        kernel_entry("raycast/candidates-lidar-error-overlay", k2_src,
                     overlay.pre, overlay.pre / n_ov, k2s["pre"]),
        kernel_entry("raycast/lidar-error-overlay", k2_src, overlay.march,
                     overlay.march / n_ov, k2s),
        kernel_entry("raycast/candidates-renderer", k2_src,
                     rl["candidates"], rl["candidates"] / rr["renders"],
                     k2f["pre"]),
        kernel_entry("raycast/renderer", k2_src, rl["raycast"],
                     rl["raycast"] / rr["renders"], k2f),
    ]
    # phase 17d's static and dynamic batch evaluations (1 and 2 launches a
    # frame over the sequence maps) with 17e's times
    kernels.append(kernel_entry("integrate/sequence-maps", k1_src,
                                p17["launches"], p17["launches"] / BE_FRAMES,
                                p17["k1s"]))
    # phase 18's soaks (the static soak's launches with the times at its
    # last map; the dynamic soak's volume fusions with its largest one's)
    # and the oversize fallback's reps
    st, dy = p18["soaks"]["static"], p18["soaks"]["dynamic"]
    fb = p18["fallback"]
    kernels += [
        kernel_entry("integrate/soak-static", k1_src,
                     st["launches"]["integrate"],
                     st["launches"]["integrate"] / st["fused"], st["k1"]),
        kernel_entry("raycast/candidates-soak-static", k2_src,
                     st["launches"]["candidates"],
                     st["launches"]["candidates"] / st["fused"],
                     st["k2"]["pre"]),
        kernel_entry("raycast/soak-static", k2_src,
                     st["launches"]["raycast"],
                     st["launches"]["raycast"] / st["fused"], st["k2"]),
        kernel_entry("integrate/soak-dynamic-volumes", k1_src,
                     dy["volume_calls"],
                     dy["volume_calls"] / dy["dispatches"], dy["k1"]),
        kernel_entry("integrate/oversize-fallback", k1_src, fb["launches"],
                     1.0, fb["k1"]),
    ]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"paths whose kernel never launched: {idle}")
    say("done", f"phases 1-18 in {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
