"""Diagnose the VO forward-scale bias: the counterpart of
``scripts/vo_diag.py``. Compares the measured previous and current
stereo disparities (from the LK-refined RawFlow rows of
``pipeline/sparse_sf.py``) with the renderer's exact disparity, frame by
frame, on ``vo_drift``'s sequence.

If the previous pair's disparity (u1p - u2p) is biased high against the
truth while the current pair's (u1 - u2c) is not, the triangulated
previous points sit too close and the estimated forward translation
shrinks in proportion: the drift ``vo_drift`` measures.

    python -m dynslam_tpu_torch.scripts.vo_diag [--frames 12] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from dynslam_tpu_torch.scripts.vo_drift import (
    BASELINE, provider, render_sequence,
)

W, H, F = 320, 96, 260.0


def diagnose(seq: dict, device=None) -> dict:
    """Median (over frames) of each frame's median bias, in px: current
    pair's disparity, previous pair's disparity, and the radial flow
    against the flow the true depth and motion predict."""
    poses = seq["poses"].astype(np.float64)
    n = len(poses)
    bf = BASELINE * F
    prov = provider(W, H, F, device)
    dprev, dcur, flow = [], [], []

    def gt_disp_at(i, u, v):
        ui = np.clip(np.round(u).astype(int), 0, W - 1)
        vi = np.clip(np.round(v).astype(int), 0, H - 1)
        return seq["disparity"][i][vi, ui]

    for i in range(n):
        prov.compute_sparse_sf(seq["left"][i], seq["right"][i])
        if i == 0:
            continue
        rows = prov.get_flow().matches  # u1 v1 u2c v2c u1p v1p u2p v2p
        if rows.shape[0] == 0:
            continue
        u1, v1, u2c = rows[:, 0], rows[:, 1], rows[:, 2]
        u1p, v1p, u2p = rows[:, 4], rows[:, 5], rows[:, 6]
        g_cur, g_prev = gt_disp_at(i, u1, v1), gt_disp_at(i - 1, u1p, v1p)
        ok_c, ok_p = g_cur > 1.0, g_prev > 1.0
        dcur.append(np.median((u1 - u2c)[ok_c] - g_cur[ok_c]))
        dprev.append(np.median((u1p - u2p)[ok_p] - g_prev[ok_p]))
        # the radial flow bias: the previous point at its true depth moved
        # by the true motion, against the measured current position
        gt_delta = np.linalg.inv(poses[i]) @ poses[i - 1]
        z_prev = np.where(g_prev > 0.5, bf / np.maximum(g_prev, 1e-6), 0)
        P = np.stack([(u1p - W / 2) / F * z_prev, (v1p - H / 2) / F * z_prev,
                      z_prev, np.ones_like(z_prev)], -1)
        Pc = (gt_delta @ P.T).T
        ok_f = (Pc[:, 2] > 0.5) & (z_prev > 0)
        r_pred = Pc[ok_f, 0] / Pc[ok_f, 2] * F
        r_meas = u1[ok_f] - W / 2
        flow.append(np.median((r_meas - r_pred) * np.sign(r_pred)))
    return dict(cur=float(np.median(dcur)), prev=float(np.median(dprev)),
                flow=float(np.median(flow)), frames=n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of CUDA")
    ap.add_argument("--speed", type=float, default=0.5)
    args = ap.parse_args(argv)
    r = diagnose(render_sequence(args.frames, W, H, F, args.speed, 0.002),
                 "cpu" if args.cpu else None)
    print(f"[vo_diag] median disparity bias vs GT over {r['frames'] - 1} "
          "frames:")
    print(f"  current pair (u1 - u2c):  {r['cur']:+.4f} px")
    print(f"  previous pair (u1p - u2p): {r['prev']:+.4f} px")
    print(f"  radial flow bias (meas - pred along radial dir): "
          f"{r['flow']:+.4f} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
