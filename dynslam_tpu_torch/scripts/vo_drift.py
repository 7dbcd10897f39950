"""VO forward-scale drift gauge (BASELINE config 2 at length): the
counterpart of ``scripts/vo_drift.py``.

Renders a synthetic forward-motion sequence (KITTI-shaped geometry
scaled down to 320x96, f = 260: the round-2 measurement configuration),
runs the sparse-scene-flow VO chain (``pipeline/sparse_sf.py``), and
reports:

  - per-frame forward-scale drift: the median of |t_est| / |t_gt| - 1
    over frame deltas (the bias that compounds into trajectory error)
  - the trajectory RMSE of camera-centre error over the sequence

The targets (VERDICT item 3): |drift| <= 0.3 %/frame and RMSE <= 0.5 m
over 100 frames. Frames render in a pool of processes when they are
many, cached under ``dynslam_tpu_torch/_build/``.

    python -m dynslam_tpu_torch.scripts.vo_drift [--frames 100] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

#: the gauge's targets: median scale drift (% a frame) and RMSE (m)
MAX_DRIFT_PCT, MAX_RMSE_M = 0.3, 0.5
#: the gauge's scene seed, baseline (m) and VO stereo range
SCENE_SEED, BASELINE, MAX_DISPARITY = 5, 0.537, 64


def sequence_set(n: int, width: int, height: int, focal: float,
                 speed: float, yaw_rate: float):
    """The ``RenderSet`` of the gauge's frames: gray pairs as float32
    ``clip(g * 255)`` (the JAX script's input) and the true disparity."""
    from dynslam_tpu_torch.config import Intrinsics, StereoCalibration
    from dynslam_tpu_torch.io.synthetic import straight_trajectory
    from dynslam_tpu_torch.scripts.bench_setup import RenderSet

    return RenderSet(
        f"vo_seq-{width}x{height}x{n}-f{focal}-v{speed}-y{yaw_rate}-s"
        f"{SCENE_SEED}", straight_trajectory(n, speed=speed,
                                             yaw_rate=yaw_rate),
        dict(seed=SCENE_SEED), Intrinsics(focal, focal, width / 2,
                                          height / 2),
        StereoCalibration(BASELINE, focal), width, height, gray="float",
        keep=("left", "right", "disparity"))


def render_sequence(n: int, width: int, height: int, focal: float,
                    speed: float, yaw_rate: float) -> dict:
    """``sequence_set``'s frames and poses (cam-to-world), rendered once
    and cached."""
    from dynslam_tpu_torch.scripts.bench_setup import render_sets

    return render_sets([sequence_set(n, width, height, focal, speed,
                                     yaw_rate)])[0]


def provider(width: int, height: int, focal: float, device=None):
    from dynslam_tpu_torch.config import (
        StereoCalibration, VisualOdometryParams,
    )
    from dynslam_tpu_torch.pipeline.sparse_sf import SparseSFProvider

    return SparseSFProvider((focal, width / 2, height / 2),
                            StereoCalibration(BASELINE, focal),
                            VisualOdometryParams(max_disparity=MAX_DISPARITY),
                            device=device)


def drift(seq: dict, width: int, height: int, focal: float, device=None,
          log=None) -> dict:
    """Run the VO chain over ``seq``: the median scale drift (% a
    frame), the trajectory RMSE, the final error (m) and the path
    length (m)."""
    poses = seq["poses"].astype(np.float64)
    n = len(poses)
    prov = provider(width, height, focal, device)
    est_pose = np.eye(4)
    est_traj = [np.eye(4)]
    scales = []
    for i in range(n):
        prov.compute_sparse_sf(seq["left"][i], seq["right"][i])
        if i == 0:
            continue
        delta = prov.get_latest_motion().astype(np.float64)
        est_pose = delta @ est_pose
        est_traj.append(est_pose.copy())
        gt = np.linalg.inv(poses[i]) @ poses[i - 1]
        tn_gt = np.linalg.norm(gt[:3, 3])
        if tn_gt > 1e-6:
            scales.append(np.linalg.norm(delta[:3, 3]) / tn_gt - 1.0)
        if log and i % 20 == 0:
            err = np.linalg.norm(np.linalg.inv(est_pose)[:3, 3]
                                 - poses[i][:3, 3])
            log(f"[vo_drift] frame {i}: traj err {err:.3f} m, median scale "
                f"drift so far {np.median(scales) * 100:+.2f} %/frame")
    errs = [np.linalg.norm(np.linalg.inv(est_traj[i])[:3, 3]
                           - poses[i][:3, 3]) for i in range(n)]
    path = sum(np.linalg.norm((np.linalg.inv(poses[i]) @ poses[i - 1])
                              [:3, 3]) for i in range(1, n))
    return dict(drift_pct=float(np.median(scales)) * 100,
                rmse=float(np.sqrt(np.mean(np.square(errs)))),
                final_err=float(errs[-1]), path=float(path), frames=n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of CUDA")
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--yaw_rate", type=float, default=0.002)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--focal", type=float, default=260.0)
    args = ap.parse_args(argv)

    seq = render_sequence(args.frames, args.width, args.height, args.focal,
                          args.speed, args.yaw_rate)
    r = drift(seq, args.width, args.height, args.focal,
              "cpu" if args.cpu else None,
              log=lambda m: print(m, file=sys.stderr))
    print(f"[vo_drift] {r['frames']} frames, path {r['path']:.1f} m")
    print(f"[vo_drift] median per-frame scale drift: {r['drift_pct']:+.3f} %")
    print(f"[vo_drift] trajectory RMSE: {r['rmse']:.3f} m (final err "
          f"{r['final_err']:.3f} m, {r['final_err'] / r['path'] * 100:.1f} % "
          "of path)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
