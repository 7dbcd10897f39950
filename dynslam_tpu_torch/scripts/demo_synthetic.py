"""Headless demo: the counterpart of ``scripts/demo_synthetic.py``. It
builds a synthetic KITTI-layout sequence, runs the staged pipeline on it
(``build_dynslam``), and writes raycast previews, the trajectory and the
timing report: the replacement for the reference's Pangolin GUI loop
(DynSLAMGUI.cpp) where there is no window.

    python -m dynslam_tpu_torch.scripts.demo_synthetic --frames 10 \\
        --out /path/to/demo [--dynamic] [--live-stereo] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--width", type=int, default=240)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq-root", default=None,
                    help="existing KITTI-layout sequence (default: generate)")
    ap.add_argument("--dynamic", action="store_true",
                    help="enable dynamic-object reconstruction")
    ap.add_argument("--live-stereo", action="store_true",
                    help="census matcher depth instead of precomputed")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)

    from dynslam_tpu_torch.config import (
        DynSlamConfig, MapParams, SceneParams, StereoMatcherParams,
        VisualOdometryParams,
    )
    from dynslam_tpu_torch.io.calib import read_kitti_poses, write_kitti_poses
    from dynslam_tpu_torch.io.images import write_png
    from dynslam_tpu_torch.io.synthetic import write_kitti_sequence
    from dynslam_tpu_torch.pipeline.builder import build_dynslam
    from dynslam_tpu_torch.pipeline.mapping import PreviewType

    os.makedirs(args.out, exist_ok=True)
    root = args.seq_root
    if root is None:
        root = os.path.join(args.out, "sequence")
        print(f"[demo] generating {args.frames}-frame synthetic sequence...")
        write_kitti_sequence(root, num_frames=args.frames, width=args.width,
                             height=args.height, with_dynamic=args.dynamic)

    cfg = DynSlamConfig(
        dynamic_mode=args.dynamic,
        scene=SceneParams(voxel_size_m=0.08, mu_m=0.32),
        map=MapParams(pool_capacity=32768, local_dims=(96, 40, 96),
                      max_new_blocks_per_frame=6144),
        vo=VisualOdometryParams(max_candidates=2048, max_matches=1024,
                                ransac_iters=120, max_disparity=96),
        stereo=StereoMatcherParams(max_disparity=96),
    )
    dyn, input_ = build_dynslam(
        root, cfg, use_live_stereo=args.live_stereo,
        with_instances=args.dynamic, min_detection_size_px=8,
        device="cpu" if args.cpu else None)

    n = 0
    while dyn.process_frame(input_):
        ms = dyn.last_frame_ms()
        print(f"[Finished frame {n} in {ms:.1f} ms @ "
              f"{1000.0 / max(ms, 1e-3):.2f} FPS]")
        if n >= 1:
            for p in (PreviewType.COLOR, PreviewType.DEPTH,
                      PreviewType.NORMAL):
                write_png(
                    os.path.join(args.out, f"frame{n:04d}_{p.value}.png"),
                    dyn.get_static_map_raycast_preview(preview=p))
        n += 1
    dyn.finalize()

    est = np.stack([np.linalg.inv(p) for p in dyn.pose_history[1:]])
    write_kitti_poses(os.path.join(args.out, "trajectory.txt"), est)
    rmse = None
    gt_path = os.path.join(root, "ground-truth-poses.txt")
    if os.path.exists(gt_path):
        gt = read_kitti_poses(gt_path)
        m = min(len(gt), len(est))
        rmse = float(np.sqrt(np.mean([
            np.sum((est[k][:3, 3] - gt[k][:3, 3]) ** 2) for k in range(m)])))
        print(f"[demo] trajectory RMSE vs GT: {rmse:.4f} m over {m} frames")

    eng = dyn.static_scene
    print(f"[demo] map blocks: {eng.get_used_block_count()}, "
          f"{eng.get_used_memory_bytes() / 1e6:.1f} MB; decay saved "
          f"{eng.get_saved_decay_memory_bytes() / 1e6:.1f} MB")
    print("[demo] timing:\n" + dyn.get_timing_report())
    print(f"[demo] outputs in {args.out}")
    return dict(frames=n, rmse=rmse, trajectory=est)


if __name__ == "__main__":
    main()
    sys.exit(0)
