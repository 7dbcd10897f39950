"""Cost attribution for the fused dynamic step: host and device ms a
frame of each of the step's named ranges (``fused_dyn.*``,
``pipeline/fused_dynamic.py::_dyn_stage``, and the static step's
``fused_step.*`` inside ``fused_dyn.static``), read from a
torch.profiler trace by ``bench_setup.profile_frames``, at bench.py's
dynamic configuration on the bench's dynamic sequence and its MNC dumps.

The counterpart of ``scripts/profile_dynamic.py``, which traces stages
out of the compiled step (``fused_dynamic_step``'s ``profile_skip``) and
takes the marginal cost of each. ``profile_skip`` is not ported
(ROADMAP's "Don't port" list): the port runs eagerly, so a stage's own
range already times it, on the host and on the device.

    python -m dynslam_tpu_torch.scripts.profile_dynamic [--frames 12] \\
        [--warmup 3] [--k4] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

#: the ranges every eval-off frame of the dynamic step passes through
STAGES = tuple(f"fused_dyn.{s}" for s in (
    "associate", "obj_ransac", "instances", "cut", "static", "fetch_wait",
    "tracker")) + tuple(
    f"fused_step.{s}" for s in ("upload", "stereo", "features", "egomotion",
                                "allocate", "integrate", "raycast", "decay"))


def profile(config, left, right, detections, warmup: int, out_dir: Path,
            device=None, tag: str = "profile") -> dict:
    """Frames ``0..warmup`` of (left, right, detections) through
    ``build_fused_dynamic``, the rest under the profiler; returns
    {stage: (host ms, device ms) a frame} and raises when a stage of
    ``STAGES`` did not run."""
    import torch

    from dynslam_tpu_torch.pipeline.builder import build_fused_dynamic
    from dynslam_tpu_torch.scripts.bench_setup import profile_frames

    pipe = build_fused_dynamic(config, config.calibration, device=device)
    cuda = pipe.device.type == "cuda"

    # the frames go to the device first, as the JAX script's do
    lgs = [torch.from_numpy(x).to(pipe.device, torch.float32) for x in left]
    rgs = [torch.from_numpy(x).to(pipe.device, torch.float32) for x in right]
    rgbs = [torch.from_numpy(x).to(pipe.device)[..., None].expand(
        *x.shape, 3).contiguous() for x in left]

    def frame(i):
        pipe.process_frame(lgs[i], rgs[i], rgbs[i], detections[i])

    n = len(left)
    for i in range(warmup + 1):
        frame(i)
    rest = range(warmup + 1, n)

    def run():
        for i in rest:
            frame(i)
        pipe._finish_prev()
    summary = profile_frames(run, len(rest), out_dir, tag=tag,
                             name=f"{tag}_trace.json", cuda=cuda)
    missing = [s for s in STAGES if s not in summary["stages"]]
    if missing:
        raise AssertionError(f"stages that never ran: {missing}")
    return {s: tuple(v[:2]) for s, v in summary["stages"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of CUDA")
    ap.add_argument("--k4", action="store_true",
                    help="quarter instance config (max_objects=4, "
                         "max_detections=4) instead of the default 8/16")
    args = ap.parse_args(argv)

    from dynslam_tpu_torch.io.segmentation import (
        PrecomputedSegmentationProvider,
    )
    from dynslam_tpu_torch.scripts import bench_setup as bs

    n = min(args.frames, bs.N_FRAMES)
    root = bs.ensure_seq(dynamic=True)
    config = bs.bench_config(dynamic=True, k4=args.k4)
    segp = PrecomputedSegmentationProvider(root + "/seg_image_2/mnc")
    dets = [segp.segment_frame(None).instance_detections for _ in range(n)]
    left, right = bs.load_frames(root, n)
    res = profile(config, left, right, dets, args.warmup,
                  bs.BUILD_DIR / "profile_dynamic",
                  "cpu" if args.cpu else None)
    print(json.dumps({s: {"host_ms": round(h, 3), "device_ms": round(d, 3)}
                      for s, (h, d) in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
