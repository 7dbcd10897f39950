"""Offline sequence preprocessing, the ``preprocess-sequence.sh`` role: the
counterpart of ``scripts/preprocess_sequence.py``, with its flags and its
dumps byte for byte.

From a raw stereo sequence (KITTI odometry or tracking layout: images and
calibration) it writes the precomputed dumps the pipeline reads:

- ``precomputed-depth/Frames/%04d.xml``: OpenCV XML int16 depth in mm
  (the ELAS role, ``io/images.py::write_opencv_xml``);
- ``precomputed-depth-dispnet/%06d.pfm``: float disparity (the DispNet
  role);
- ``seg_image_2/mnc/%06d.png.%04d.{result,mask}.txt`` and ``cls_%06d.png``
  (the MNC role, with ``--seg_params``: SegNet-lite params written by
  either package's ``segnet.save_params``).

Depth comes from the census matcher (``ops/stereo.py``), segmentation
from ``models/segnet.py``'s learned provider, both on CUDA unless
``--cpu``.

    python -m dynslam_tpu_torch.scripts.preprocess_sequence \\
        --dataset_root /path/to/seq [--seg_params segnet.msgpack] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--dataset_type", default="kitti-odometry",
                   choices=["kitti-odometry", "kitti-tracking"])
    p.add_argument("--sequence_id", type=int, default=0,
                   help="kitti-tracking sequence id")
    p.add_argument("--frames", type=int, default=-1,
                   help="limit the number of frames (-1 = all)")
    p.add_argument("--max_disparity", type=int, default=128)
    p.add_argument("--fill_gaps", type=int, default=8,
                   help="ELAS-role horizontal gap interpolation (px, 0=off)")
    p.add_argument("--min_depth_m", type=float, default=0.5)
    p.add_argument("--max_depth_m", type=float, default=20.0)
    p.add_argument("--no_xml", action="store_true",
                   help="skip the ELAS-role XML depth dump")
    p.add_argument("--no_pfm", action="store_true",
                   help="skip the DispNet-role PFM disparity dump")
    p.add_argument("--seg_params", default="",
                   help="SegNet params (segnet.save_params msgpack); "
                        "empty = skip segmentation dumps")
    p.add_argument("--seg_threshold", type=float, default=0.5)
    p.add_argument("--min_detection_size", type=int, default=45)
    p.add_argument("--overwrite", action="store_true",
                   help="regenerate dumps even if present (the reference "
                        "script skips sequences that already have them)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of CUDA")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from dynslam_tpu_torch.config import StereoMatcherParams
    from dynslam_tpu_torch.device import resolve_device
    from dynslam_tpu_torch.io import input as dyn_input
    from dynslam_tpu_torch.io.calib import read_kitti_calibration
    from dynslam_tpu_torch.io.depth_providers import (
        StereoMatcherDepthProvider,
    )
    from dynslam_tpu_torch.io.images import read_png, write_opencv_xml
    from dynslam_tpu_torch.io.segmentation import write_mnc_dump
    from dynslam_tpu_torch.utils.pfm import write_pfm

    device = resolve_device("cpu" if args.cpu else None)
    root = args.dataset_root
    if args.dataset_type == "kitti-tracking":
        cfg = dyn_input.kitti_tracking_config(args.sequence_id)
        dispnet_cfg = dyn_input.kitti_tracking_dispnet_config(
            args.sequence_id)
    else:
        cfg = dyn_input.kitti_odometry_config()
        dispnet_cfg = dyn_input.kitti_odometry_dispnet_config()

    left_dir = os.path.join(root, cfg.left_color_folder)
    right_dir = os.path.join(root, cfg.right_color_folder)
    if not (os.path.isdir(left_dir) and os.path.isdir(right_dir)):
        raise SystemExit(
            f"stereo folders missing: {left_dir!r} / {right_dir!r} "
            f"(expected the {args.dataset_type} layout)")
    calib = read_kitti_calibration(os.path.join(root, cfg.calibration_fname))
    scal = calib.stereo_calibration()
    print(f"[preprocess] f={scal.focal_length_px:.1f} "
          f"B={scal.baseline_m:.3f} m")

    n_frames = len([f for f in os.listdir(left_dir) if f.endswith(".png")])
    if args.frames > 0:
        n_frames = min(n_frames, args.frames)

    xml_dir = os.path.join(root, cfg.depth_folder)
    pfm_dir = os.path.join(root, dispnet_cfg.depth_folder)
    seg_dir = os.path.join(root, cfg.segmentation_folder)
    if not args.no_xml:
        os.makedirs(xml_dir, exist_ok=True)
    if not args.no_pfm:
        os.makedirs(pfm_dir, exist_ok=True)

    # "already segmented / already computed" fast path (the reference
    # script's check, preprocess-sequence.sh:186-193,241-247)
    if not args.overwrite:
        last_xml = os.path.join(xml_dir,
                                cfg.depth_fname_format % (n_frames - 1))
        if not args.no_xml and os.path.exists(last_xml):
            print("[preprocess] depth dumps already present; "
                  "use --overwrite to regenerate")
            args.no_xml = args.no_pfm = True

    matcher = StereoMatcherDepthProvider(
        StereoMatcherParams(max_disparity=args.max_disparity,
                            fill_gaps=args.fill_gaps), device=device)

    seg_provider = None
    if args.seg_params:
        from dynslam_tpu_torch.models import segnet

        model = segnet.load_params(args.seg_params,
                                   segnet.create_model()).to(device)
        seg_provider = segnet.LearnedSegmentationProvider(
            model, threshold=args.seg_threshold,
            min_detection_size_px=args.min_detection_size)
        os.makedirs(seg_dir, exist_ok=True)

    for f in range(n_frames):
        left = read_png(os.path.join(left_dir, cfg.fname_format % f))
        right = read_png(os.path.join(right_dir, cfg.fname_format % f))

        if not (args.no_xml and args.no_pfm):
            disp = matcher.disparity_map_from_stereo(left, right).cpu() \
                .numpy()
            if not args.no_pfm:
                write_pfm(os.path.join(pfm_dir, "%06d.pfm" % f), disp)
            if not args.no_xml:
                with np.errstate(divide="ignore"):
                    depth_m = np.where(
                        disp > 0.0,
                        scal.focal_length_px * scal.baseline_m
                        / np.maximum(disp, 1e-6),
                        0.0)
                depth_mm = np.where(
                    (depth_m >= args.min_depth_m)
                    & (depth_m <= args.max_depth_m),
                    np.clip(depth_m * 1000.0, 0, 32767),
                    0,
                ).astype(np.int16)
                write_opencv_xml(
                    os.path.join(xml_dir, cfg.depth_fname_format % f),
                    "depth", depth_mm)

        if seg_provider is not None:
            dets = seg_provider.raw_detections(left)
            write_mnc_dump(seg_dir, f, dets,
                           preview=seg_provider.get_seg_preview())

        if f % 25 == 0 or f == n_frames - 1:
            print(f"[preprocess] frame {f + 1}/{n_frames}", flush=True)

    print(f"[preprocess] done: {n_frames} frames under {root}")
    print("[preprocess] run e.g.:")
    print(f"  python -m dynslam_tpu_torch.main --dataset_root {root}"
          + (" --use_dispnet" if args.no_xml else ""))


if __name__ == "__main__":
    main()
