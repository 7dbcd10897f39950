"""Produce the low-resolution variant of a KITTI-layout sequence: the
counterpart of ``scripts/scale_sequence.py`` (the reference's
``scripts/scale_sequence.py`` + ``preprocess-sequence.sh``: resize the
images, recompute depth and segmentation at the new size), feeding the
``kitti_odometry_lowres_config(factor)`` preset (``io/input.py``). Its
files are byte for byte the JAX script's.

Outputs, for --scale F (the reference's folder names):
  image_0_F.2f/ image_1_F.2f/      gray pair   (from colour if absent)
  image_2_F.2f/ image_3_F.2f/      colour pair
  precomputed-depth-elas-F.2f/Frames/%04d.xml
      depth recomputed at the low resolution with the census matcher
      (the libelas substitute), not resized, as the reference reruns
      ELAS at the new size
  seg_image_2-F.2f/mnc/
      MNC dumps rescaled (bbox coordinates scaled, masks nearest-resized)

Images go through ``io/images.py`` (``read_png``, ``resize_area``,
``bgr_to_gray``, ``write_png``: OpenCV's ``imread``, ``INTER_AREA``,
``COLOR_BGR2GRAY`` and ``imwrite``). The JAX script reads with
``IMREAD_UNCHANGED``; this one reads 8-bit gray, RGB and RGBA files and
writes gray files as gray and the others as RGB (an alpha channel is
dropped).

    python -m dynslam_tpu_torch.scripts.scale_sequence \\
        --dataset_root <seq> --scale 0.5 [--cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import re


def _is_gray_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(26)[25] == 0  # IHDR colour type


def resize_images(src: str, dst: str, scale: float, force: bool,
                  to_gray: bool = False) -> int:
    from dynslam_tpu_torch.io.images import (
        bgr_to_gray, read_png, resize_area, write_png,
    )

    if not os.path.isdir(src):
        return 0
    if os.path.isdir(dst) and not force:
        print(f"[scale] {dst} exists; skipping (use --force)")
        return len(os.listdir(dst))
    os.makedirs(dst, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(src)):
        if not fname.endswith(".png"):
            continue
        path = os.path.join(src, fname)
        img = read_png(path)
        if _is_gray_png(path):
            img = img[..., 0]
        out = resize_area(img, None, scale, scale)
        if to_gray and out.ndim == 3:
            out = bgr_to_gray(out[..., ::-1])
        write_png(os.path.join(dst, fname), out)
        n += 1
    print(f"[scale] {dst}: {n} images")
    return n


def compute_depth(root: str, scale: float, force: bool, cpu: bool) -> None:
    import numpy as np
    import torch

    from dynslam_tpu_torch.config import StereoMatcherParams
    from dynslam_tpu_torch.device import resolve_device
    from dynslam_tpu_torch.io.calib import read_kitti_calibration
    from dynslam_tpu_torch.io.images import read_png_gray, write_opencv_xml
    from dynslam_tpu_torch.ops import stereo as stereo_ops

    out_dir = os.path.join(root, f"precomputed-depth-elas-{scale:.2f}",
                           "Frames")
    if os.path.isdir(out_dir) and not force:
        print(f"[scale] {out_dir} exists; skipping")
        return
    os.makedirs(out_dir, exist_ok=True)
    device = resolve_device("cpu" if cpu else None)

    calib = read_kitti_calibration(os.path.join(root, "calib.txt"))
    fx = float(calib.proj_left_color[0, 0]) * scale
    baseline = float(
        abs(calib.proj_right_color[0, 3] / calib.proj_right_color[0, 0]))
    bf = baseline * fx

    left_dir = os.path.join(root, f"image_2_{scale:.2f}")
    right_dir = os.path.join(root, f"image_3_{scale:.2f}")
    params = StereoMatcherParams(max_disparity=max(32, int(128 * scale)))
    for i, fname in enumerate(sorted(os.listdir(left_dir))):
        lg = read_png_gray(os.path.join(left_dir, fname))
        rg = read_png_gray(os.path.join(right_dir, fname))
        disp = stereo_ops.compute_disparity(
            torch.from_numpy(lg.astype(np.float32)).to(device),
            torch.from_numpy(rg.astype(np.float32)).to(device),
            params).cpu().numpy()
        with np.errstate(divide="ignore"):
            depth_mm = np.where(disp > 0.1,
                                bf / np.maximum(disp, 0.1) * 1000.0, 0.0)
        depth_mm = np.clip(depth_mm, 0, 32767).astype(np.int16)
        frame_no = int(re.search(r"(\d+)", fname).group(1))
        write_opencv_xml(os.path.join(out_dir, f"{frame_no:04d}.xml"),
                         "depth", depth_mm)
        if i % 25 == 0:
            print(f"[scale] depth {i + 1} frames", flush=True)
    print(f"[scale] depth -> {out_dir}")


def rescale_segmentation(root: str, scale: float, force: bool) -> None:
    import numpy as np

    from dynslam_tpu_torch.io.images import resize_nearest

    src_dir = os.path.join(root, "seg_image_2", "mnc")
    if not os.path.isdir(src_dir):
        print("[scale] no seg_image_2/mnc dumps found; skipping segmentation")
        return
    dst_dir = os.path.join(root, f"seg_image_2-{scale:.2f}", "mnc")
    if os.path.isdir(dst_dir) and not force:
        print(f"[scale] {dst_dir} exists; skipping")
        return
    os.makedirs(dst_dir, exist_ok=True)

    n = 0
    for res_path in sorted(glob.glob(os.path.join(src_dir,
                                                  "*.result.txt"))):
        mask_path = res_path.replace(".result.txt", ".mask.txt")
        if not os.path.exists(mask_path):
            continue
        with open(res_path) as f:
            line = f.readline().strip()
        bracket, rest = line.split("]", 1)
        x0, y0, x1, y1 = (int(float(v))
                          for v in bracket.strip("[").split()[:4])
        nx0, ny0 = int(round(x0 * scale)), int(round(y0 * scale))
        nx1 = max(nx0, int(round(x1 * scale)))
        ny1 = max(ny0, int(round(y1 * scale)))
        mask = np.loadtxt(mask_path, dtype=np.uint8, ndmin=2)
        new_mask = resize_nearest(mask, (nx1 - nx0 + 1, ny1 - ny0 + 1))
        base = os.path.basename(res_path).replace(".result.txt", "")
        with open(os.path.join(dst_dir, base + ".result.txt"), "w") as f:
            f.write(f"[{nx0} {ny0} {nx1} {ny1} 0],{rest}\n")
        np.savetxt(os.path.join(dst_dir, base + ".mask.txt"), new_mask,
                   fmt="%d")
        n += 1
    print(f"[scale] segmentation -> {dst_dir} ({n} detections)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--scale", type=float, required=True)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the stereo matcher on the CPU instead of "
                         "CUDA")
    args = ap.parse_args(argv)
    root = args.dataset_root
    f = args.scale

    # colour pairs, then gray pairs (from colour where image_0/1 are
    # absent, as in synthetic sequences)
    resize_images(os.path.join(root, "image_2"),
                  os.path.join(root, f"image_2_{f:.2f}"), f, args.force)
    resize_images(os.path.join(root, "image_3"),
                  os.path.join(root, f"image_3_{f:.2f}"), f, args.force)
    for gray, color in (("image_0", "image_2"), ("image_1", "image_3")):
        src = os.path.join(root, gray)
        if not os.path.isdir(src):
            src = os.path.join(root, color)
        resize_images(src, os.path.join(root, f"{gray}_{f:.2f}"), f,
                      args.force, to_gray=True)

    compute_depth(root, f, args.force, args.cpu)
    rescale_segmentation(root, f, args.force)
    print("[scale] done")


if __name__ == "__main__":
    main()
