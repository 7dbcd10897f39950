"""Timing of the oversized-mask full-frame fallback
(``pipeline/fused_dynamic.py::fuse_slot_fullframe``, one K1 launch over
one pooled object volume at the full frame) and of its host-side
preparation, with fresh random inputs each rep: the counterpart of
``scripts/measure_fallback.py``, at bench.py's dynamic configuration.

The input is the JAX script's close car: a 600x250 mask (scaled to the
frame at other sizes) at z 3-6 m, random colour. The volumes are the
pool's stacked state (``tsdf.create_pool``), the port's counterpart of
JAX's state broadcast over S slots. A rep's run ends in
``torch.cuda.synchronize()`` (JAX: ``np.asarray(fidx)``).

    python -m dynslam_tpu_torch.scripts.measure_fallback [--reps 6] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def close_car(h: int, w: int, rng):
    """(depth (H, W) f32, mask (H, W) bool, rgb (H, W, 3) uint8): the
    mask's rows 60-309 and columns 300-899 at 1242x375, scaled to other
    sizes, at uniform random depths of 3-6 m."""
    depth = np.zeros((h, w), np.float32)
    mask = np.zeros((h, w), bool)
    mask[round(60 * h / 375):round(310 * h / 375),
         round(300 * w / 1242):round(900 * w / 1242)] = True
    depth[mask] = rng.uniform(3.0, 6.0, mask.sum()).astype(np.float32)
    rgb = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    return depth, mask, rgb


def measure(config, reps: int = 6, device=None, rng=None, log=print) -> dict:
    """``reps`` fallback fusions into slot ``rep % S`` of a fresh pool
    (the first resets its slot). Returns the pool and its fusion clocks,
    and per rep the host prep, upload and run ms."""
    import torch

    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic
    from dynslam_tpu_torch.pipeline.fused_dynamic import fuse_slot_fullframe

    pipe = build_fused_dynamic(config, config.calibration, device=device)
    dev = pipe.device
    cuda = dev.type == "cuda"
    rng = rng or np.random.default_rng()
    h, w = config.frame_height, config.frame_width
    inst = tsdf.create_pool(pipe.icfg, pipe.S, dev)
    fidx = np.zeros(pipe.S, np.int32)
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        depth, mask, rgb = close_car(h, w, rng)
        t_host = time.perf_counter() - t0

        t0 = time.perf_counter()
        d_dev = torch.from_numpy(depth).to(dev)
        r_dev = torch.from_numpy(rgb).to(dev)
        if cuda:
            torch.cuda.synchronize()
        t_up = time.perf_counter() - t0

        t0 = time.perf_counter()
        fuse_slot_fullframe(pipe.icfg, True, inst, fidx, rep % pipe.S, d_dev,
                            r_dev, mask, np.eye(4, dtype=np.float32),
                            rep == 0, pipe.intr_host, 1.0, 200)
        if cuda:
            torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        times.append(dict(host_ms=t_host * 1e3, upload_ms=t_up * 1e3,
                          run_ms=t_run * 1e3))
        log(f"[measure] rep {rep}: host prep {t_host * 1e3:.1f} ms, upload "
            f"{t_up * 1e3:.1f} ms, dispatch+run {t_run * 1e3:.1f} ms")
    return dict(inst=inst, fidx=fidx, times=times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)

    import torch

    from dynslam_tpu_torch.scripts.bench_setup import bench_config

    device = "cpu" if args.cpu else None
    name = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"[measure] device: {name}", file=sys.stderr)
    measure(bench_config(dynamic=True), args.reps, device,
            log=lambda m: print(m, file=sys.stderr, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
