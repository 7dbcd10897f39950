"""The drives the cells replay, made from a cell's traffic parameters and
``--seed``, and rendered on the card.

A drive is the renderer's scene of ``dynslam_tpu_torch/io/synthetic.py``
laid along the whole path: the camera moves at ``speed_m`` a frame with a
gentle yaw (``straight_trajectory``), building rows flank the road every
7 m (``default_scene``'s rule and random draws, for as many rows as the
path needs), low obstacles stand in the road every 12 m, and cars drive
in lanes, each entry of ``cars`` repeated every ``spacing_m`` for as many
copies as meet the camera during the drive.

``render`` is a torch copy of that module's ``_texture``,
``_ray_scene_intersect``, ``render_frame`` (2x supersampled gray, depth
and object ids point-sampled) and ``render_stereo_frame``, in float64,
over chunks of frames, testing each box only on the pixels its projected
corners can reach. The frames come out as the camera delivers them: uint8
gray pairs (``to_uint8_rgb``'s rounding), with the bench's +-1 sensor
noise drawn from the seed.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

#: the renderer's world: ground plane height, ray range, car half extents
GROUND_Y = 1.65
MAX_RANGE = 80.0
CAR_HALF = (0.9, 0.75, 2.1)
#: rows and obstacles laid this far past the path's end
ROWS_BEYOND_M = 80.0


class Drive(NamedTuple):
    """A drive: camera-to-world poses (N, 4, 4) and axis-aligned boxes,
    centres at frame 0 (B, 3), half extents (B, 3), velocities a frame
    (B, 3) and whether each moves (B,); float64 numpy."""

    poses: np.ndarray
    centre: np.ndarray
    half: np.ndarray
    velocity: np.ndarray
    dynamic: np.ndarray


def trajectory(n: int, speed: float, yaw_rate: float) -> np.ndarray:
    """``straight_trajectory``: forward motion with a gentle yaw."""
    poses = np.zeros((n, 4, 4))
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i] = np.eye(4)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        pos = pos + R @ np.array([0.0, 0.0, speed])
        yaw += yaw_rate
    return poses


def make_drive(traffic: dict, n_frames: int, n_rows=None) -> Drive:
    """The drive that ``traffic`` describes: ``scene_seed``, ``speed_m``,
    ``yaw_rate``, ``cars`` (entries of lane ``x``, start ``z``, speed
    ``v`` a frame and, to repeat it, ``spacing_m``) and ``layout_frames``,
    the frames its rows and cars are laid out for, whatever the stream's
    length; poses for the larger of that and ``n_frames``. ``n_rows``
    overrides the rows the path needs."""
    speed = float(traffic["speed_m"])
    n_frames = max(n_frames, int(traffic.get("layout_frames", 0)))
    poses = trajectory(n_frames, speed, float(traffic["yaw_rate"]))
    if n_rows is None:
        n_rows = int(math.ceil((n_frames * speed + ROWS_BEYOND_M) / 7.0))
    rng = np.random.default_rng(int(traffic["scene_seed"]))
    centre, half, vel = [], [], []
    for side in (-1.0, 1.0):
        for i in range(n_rows):
            z = 4.0 + i * 7.0 + rng.uniform(-1, 1)
            x = side * (4.5 + rng.uniform(0, 2.0))
            h = rng.uniform(2.0, 4.0)
            w = rng.uniform(1.0, 2.5)
            d = rng.uniform(1.5, 3.0)
            centre.append([x, GROUND_Y - h / 2.0, z])
            half.append([w / 2, h / 2, d / 2])
    for i in range(max(3, n_rows // 2)):
        centre.append([rng.uniform(-2, 2), GROUND_Y - 0.4, 12.0 + i * 12.0])
    half += [[0.6, 0.4, 0.9]] * (len(centre) - len(half))
    vel = [[0.0, 0.0, 0.0]] * len(centre)
    dynamic = [False] * len(centre)
    for car in traffic.get("cars", []):
        v = float(car["v"])
        count = 1
        if "spacing_m" in car:
            # copies that meet the camera before the drive ends
            count = int(n_frames * max(speed - v, 0.0)
                        // float(car["spacing_m"])) + 1
        for j in range(count):
            z = float(car["z"]) + j * float(car.get("spacing_m", 0.0))
            centre.append([float(car["x"]), GROUND_Y - CAR_HALF[1], z])
            half.append(list(CAR_HALF))
            vel.append([0.0, 0.0, v])
            dynamic.append(True)
    return Drive(poses, np.asarray(centre, np.float64),
                 np.asarray(half, np.float64), np.asarray(vel, np.float64),
                 np.asarray(dynamic, bool))


def _texture(p: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """View-independent procedural albedo in [0, 1] from world points."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    smooth = (0.5 + 0.25 * torch.sin(3.1 * x) * torch.sin(2.3 * z)
              + 0.15 * torch.sin(7.7 * y + 1.3 * z)
              + 0.10 * torch.sin(13.7 * x + 5.1 * y))
    cells = torch.floor(p * 3.7).to(torch.int64)
    h = (cells[..., 0] * 73856093) ^ (cells[..., 1] * 19349663) \
        ^ (cells[..., 2] * 83492791) ^ salt
    speckle = ((h & 0xFFFF) / 65535.0 - 0.5) * 0.5
    return torch.clamp(smooth + speckle, 0.02, 1.0)


def _box_window(drive: Drive, b: int, frames, c2w: np.ndarray, intr,
                w: int, h: int):
    """The pixel window (v0, v1, u0, u1) where box ``b`` can be hit from
    any of the views ``c2w`` (F, 4, 4) of ``frames``, the whole image
    where a view has corners behind and in front of the camera, or None
    where every corner of every view lies behind it."""
    fx, fy, cx, cy = intr
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float64)
    us, vs = [], []
    for f, T in zip(frames, c2w):
        centre = drive.centre[b] + drive.velocity[b] * f
        corners = centre + signs * drive.half[b]
        cam = (corners - T[:3, 3]) @ T[:3, :3]
        z = cam[:, 2]
        if (z <= 0.1).all():
            continue
        if (z <= 0.1).any():
            return 0, h, 0, w
        us += list(cam[:, 0] / z * fx + cx)
        vs += list(cam[:, 1] / z * fy + cy)
    if not us:
        return None
    u0 = max(int(math.floor(min(us))) - 1, 0)
    u1 = min(int(math.ceil(max(us))) + 2, w)
    v0 = max(int(math.floor(min(vs))) - 1, 0)
    v1 = min(int(math.ceil(max(vs))) + 2, h)
    if u0 >= u1 or v0 >= v1:
        return None
    return v0, v1, u0, u1


def _cast(drive: Drive, frames, c2w: np.ndarray, intr, w: int, h: int,
          device):
    """Rays through the pixel centres of views ``c2w`` (F, 4, 4) at frames
    ``frames``: (t (F, H, W), hit points (F, H, W, 3), object id (F, H, W):
    -1 none, 0 ground, b + 1 box b)."""
    fx, fy, cx, cy = intr
    F_ = len(frames)
    dt = torch.float64
    u = torch.arange(w, dtype=dt, device=device)
    v = torch.arange(h, dtype=dt, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rays = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)],
                       -1)
    T = torch.as_tensor(c2w, dtype=dt, device=device)
    dirs = torch.einsum("hwj,fij->fhwi", rays, T[:, :3, :3])
    org = T[:, :3, 3]  # (F, 3)
    dy = dirs[..., 1]
    ok = dy.abs() > 1e-9
    t_plane = torch.where(ok, (GROUND_Y - org[:, 1, None, None])
                          / torch.where(ok, dy, 1.0), math.inf)
    hit = (t_plane > 0.1) & (t_plane < MAX_RANGE)
    t_best = torch.where(hit, t_plane, math.inf)
    obj = torch.where(hit, 0, -1).to(torch.int32)
    inv_d = 1.0 / torch.where(dirs.abs() < 1e-12, 1e-12, dirs)
    fr = torch.as_tensor(np.asarray(frames, np.float64), device=device)
    for b in range(len(drive.centre)):
        win = _box_window(drive, b, frames, c2w, intr, w, h)
        if win is None:
            continue
        v0, v1, u0, u1 = win
        centre = torch.as_tensor(drive.centre[b], device=device) \
            + torch.as_tensor(drive.velocity[b], device=device) * fr[:, None]
        o_loc = (org - centre)[:, None, None, :]  # (F, 1, 1, 3)
        he = torch.as_tensor(drive.half[b], device=device)
        inv = inv_d[:, v0:v1, u0:u1]
        t1 = (-he - o_loc) * inv
        t2 = (he - o_loc) * inv
        t_near = torch.minimum(t1, t2).amax(-1)
        t_far = torch.maximum(t1, t2).amin(-1)
        t_hit = torch.where((t_near <= t_far) & (t_far > 0.1),
                            torch.clamp(t_near, min=0.1), math.inf)
        tb = t_best[:, v0:v1, u0:u1]
        better = t_hit < tb
        tb.copy_(torch.where(better, t_hit, tb))
        ob = obj[:, v0:v1, u0:u1]
        ob.copy_(torch.where(better, b + 1, ob))
    pts = org[:, None, None, :] + dirs * t_best[..., None]
    return t_best, pts, obj


def _shade(drive: Drive, frames, t, pts, obj, device) -> torch.Tensor:
    """Gray in [0, 1] of cast rays: the texture (in the car's own frame on
    a moving box), dark sky, distance shading."""
    finite = torch.isfinite(t)
    tex_pts = torch.where(finite[..., None], pts, 0.0)
    fr = torch.as_tensor(np.asarray(frames, np.float64), device=device)
    for b in np.flatnonzero(drive.dynamic):
        sel = obj == int(b) + 1
        centre = torch.as_tensor(drive.centre[b], device=device) \
            + torch.as_tensor(drive.velocity[b], device=device) * fr[:, None]
        tex_pts = torch.where(sel[..., None], pts - centre[:, None, None, :],
                              tex_pts)
    gray = torch.where(finite, _texture(tex_pts), 0.08)
    depth = torch.where(finite, t, 0.0)
    shade = torch.clamp(1.0 - depth / (MAX_RANGE * 1.5), 0.4, 1.0)
    return gray * torch.where(depth > 0, shade, 1.0)


def render(drive: Drive, intr, baseline: float, w: int, h: int, device,
           n=None, chunk: int = 16) -> torch.Tensor:
    """The first ``n`` frames of ``drive`` (all by default) as stereo pairs
    (``render_stereo_frame`` at supersample 2), uint8 gray (N, 2, H, W)
    (left, right) on ``device``: the right camera is the left translated
    by ``baseline`` along its x axis."""
    fx, fy, cx, cy = intr
    s = 2
    hi = (fx * s, fy * s, cx * s + (s - 1) / 2.0, cy * s + (s - 1) / 2.0)
    n = len(drive.poses) if n is None else n
    gray = torch.empty(n, 2, h, w, dtype=torch.uint8, device=device)
    for a in range(0, n, chunk):
        frames = list(range(a, min(a + chunk, n)))
        left = drive.poses[frames]
        right = left.copy()
        right[:, :3, 3] += left[:, :3, 0] * baseline
        for view, c2w in enumerate((left, right)):
            t, pts, obj = _cast(drive, frames, c2w, hi, w * s, h * s, device)
            g = _shade(drive, frames, t, pts, obj, device)
            g = g.reshape(len(frames), h, s, w, s).mean(dim=(2, 4))
            gray[a:a + len(frames), view] = torch.clamp(
                g * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return gray


def left_depth_ids(drive: Drive, frames, intr, w: int, h: int, device):
    """The left view's z-depth (F, H, W) float32 and object ids (F, H, W)
    int32 at ``frames``, point-sampled at pixel centres, as numpy."""
    t, _, obj = _cast(drive, frames, drive.poses[frames], intr, w, h, device)
    depth = torch.where(torch.isfinite(t), t, 0.0).float()
    return depth.cpu().numpy(), obj.cpu().numpy()


def add_noise(gray: torch.Tensor, seed: int) -> torch.Tensor:
    """The bench's +-1 sensor noise on uint8 frames, drawn on their device
    from ``seed``."""
    g = torch.Generator(device=gray.device).manual_seed(seed)
    noise = torch.randint(-1, 2, gray.shape, generator=g,
                          device=gray.device, dtype=torch.int16)
    return torch.clamp(gray.to(torch.int16) + noise, 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# the files the port's builder reads: calibration, a frame, MNC dumps
# ---------------------------------------------------------------------------


def write_png_gray(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG of a gray (H, W) uint8 image."""
    h, w = img.shape
    rgb = np.repeat(img[..., None], 3, axis=-1)
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data \
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_calib(path: str, intr, baseline: float) -> None:
    """A KITTI odometry ``calib.txt`` of the rig: the same projection for
    every camera, the right ones shifted by the baseline; the velodyne 5
    cm from the camera (``make_calibration``)."""
    fx, fy, cx, cy = intr
    K = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]], np.float64)
    R = K.copy()
    R[0, 3] = -fx * baseline
    velo = np.array([[0, -1, 0, 0], [0, 0, -1, -0.05], [1, 0, 0, 0.05]],
                    np.float64)

    def fmt(m):
        return " ".join(repr(float(v)) for v in m.reshape(-1))
    with open(path, "w") as f:
        for name, m in (("P0", K), ("P1", R), ("P2", K), ("P3", R),
                        ("Tr", velo)):
            f.write(f"{name}: {fmt(m)}\n")


def write_dumps(seg_folder: str, frame: int, objid: np.ndarray,
                dynamic_ids) -> int:
    """MNC dumps of frame ``frame``'s object ids (H, W): each moving box of
    at least 16 pixels as a "car" (VOC class 7) of score 0.98, its bbox
    and its bbox-sized numpy-text mask (``write_kitti_frame``'s rule).
    Returns the detections written."""
    n = 0
    for b in dynamic_ids:
        mask = objid == b + 1
        if mask.sum() < 16:
            continue
        ys, xs = np.nonzero(mask)
        x0, y0, x1, y1 = xs.min(), ys.min(), xs.max(), ys.max()
        base = os.path.join(seg_folder, f"{frame:06d}.png.{n:04d}")
        with open(base + ".result.txt", "w") as f:
            f.write(f"[{x0} {y0} {x1} {y1} 0], {0.98:.6f}, 7\n")
        np.savetxt(base + ".mask.txt",
                   mask[y0:y1 + 1, x0:x1 + 1].astype(np.uint8), fmt="%d")
        n += 1
    return n
