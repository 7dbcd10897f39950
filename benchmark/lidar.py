"""LIDAR scans of a drive, for a configuration whose file has a ``"lidar"``
object: the rig's scanner, cast on the card from the drive's own geometry
(the ground, the building rows and obstacles, the cars at each frame's
positions: the boxes ``scene.render`` draws).

The scanner sits where ``scene.write_calib``'s ``Tr`` puts the velodyne:
5 cm above and 5 cm ahead of the left camera, x forward, y left, z up.
Its beams are evenly spaced in elevation from ``elevation_deg[0]`` down
to ``elevation_deg[1]``; its azimuths are the multiples of
``azimuth_step_deg`` across the left camera's horizontal field; a beam
returns the nearest surface within ``max_range_m``. A scan keeps the
returns that project into the left image (the pixel its rounded
projection falls on is inside the frame), in scan order (beam by beam,
left to right), evenly thinned to at most ``max_points``. Each return is
one KITTI row: float32 x, y, z in the velodyne frame and a reflectance
of 0.5 (the evaluation reads x, y, z alone).

KITTI's rig, a Velodyne HDL-64E (``HDL64E``): 64 beams from +2.0 to
-24.8 degrees, 0.09-degree azimuth steps, 120 m; at KITTI odometry's
camera about 20,000 returns land in the left image, the size of the
scans the port's bench evaluated.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark import scene

#: KITTI's Velodyne HDL-64E, cut to the left camera's field
HDL64E = {"beams": 64, "elevation_deg": [2.0, -24.8],
          "azimuth_step_deg": 0.09, "max_range_m": 120.0,
          "max_points": 20000}
#: the reflectance written for every return
REFLECTANCE = 0.5
#: velodyne -> left camera, as ``scene.write_calib`` writes ``Tr``
VELO_TO_CAM = np.array([[0, -1, 0, 0], [0, 0, -1, -0.05], [1, 0, 0, 0.05],
                        [0, 0, 0, 1]], np.float64)


def validate(rig: dict) -> None:
    """Raises ValueError unless ``rig`` has exactly ``HDL64E``'s keys with
    values a scanner can have."""
    if not isinstance(rig, dict) or set(rig) != set(HDL64E):
        raise ValueError(f"a \"lidar\" object has exactly the keys "
                         f"{sorted(HDL64E)}, not {rig!r}")
    top, bottom = (float(e) for e in rig["elevation_deg"])
    if not (int(rig["beams"]) >= 1 and -90 < bottom <= top < 90
            and rig["azimuth_step_deg"] > 0 and rig["max_range_m"] > 0
            and int(rig["max_points"]) >= 1):
        raise ValueError(f"not a scanner: {rig!r}")


def directions(rig: dict, intr, w: int) -> np.ndarray:
    """Unit beam directions (R, 3) in the velodyne frame, in scan order:
    beam by beam from the top, each across the azimuths that can reach
    the left camera's image (the columns' azimuths seen from the camera,
    widened by two steps for the scanner's 5 cm offset)."""
    fx, _, cx, _ = intr
    step = float(rig["azimuth_step_deg"])
    left = math.degrees(math.atan((cx + 0.5) / fx))  # y left is +
    right = -math.degrees(math.atan((w - 0.5 - cx) / fx))
    k = np.arange(math.floor(right / step) - 2, math.ceil(left / step) + 3)
    az = np.radians(k[::-1] * step)  # left to right
    top, bottom = (float(e) for e in rig["elevation_deg"])
    n = int(rig["beams"])
    el = np.radians(np.linspace(top, bottom, n) if n > 1
                    else np.array([top]))
    ce, se = np.cos(el)[:, None], np.sin(el)[:, None]
    d = np.stack([ce * np.cos(az)[None], ce * np.sin(az)[None],
                  np.broadcast_to(se, (n, len(az)))], -1)
    return d.reshape(-1, 3)


def _cast(drive: scene.Drive, frames, dirs_v: torch.Tensor, max_range: float,
          device) -> torch.Tensor:
    """Ranges (F, R) of beams ``dirs_v`` (R, 3, velodyne frame) from the
    scanner at ``frames``; inf where a beam meets nothing within
    ``max_range``."""
    dt = torch.float64
    c2w = torch.as_tensor(drive.poses[frames], dtype=dt, device=device)
    v2c = torch.as_tensor(VELO_TO_CAM, dtype=dt, device=device)
    v2w = c2w @ v2c  # (F, 4, 4)
    dirs = torch.einsum("rj,fij->fri", dirs_v, v2w[:, :3, :3])  # (F, R, 3)
    org = v2w[:, :3, 3]  # (F, 3)
    dy = dirs[..., 1]
    down = dy > 1e-12
    t_plane = (scene.GROUND_Y - org[:, 1, None]) / torch.where(down, dy, 1.0)
    best = torch.where(down & (t_plane > 0), t_plane, math.inf)
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, 1e-12, dirs)
    # boxes within reach of a scanner position of the chunk
    fr = np.asarray(frames, np.float64)
    centres = drive.centre[:, None] + drive.velocity[:, None] * fr[None, :,
                                                                   None]
    dist = np.linalg.norm(centres - org.cpu().numpy()[None], axis=-1)
    reach = np.flatnonzero((dist - np.linalg.norm(drive.half, axis=-1)[:, None]
                            <= max_range).any(1))
    frt = torch.as_tensor(fr, device=device)
    for b in reach:
        centre = torch.as_tensor(drive.centre[b], device=device) \
            + torch.as_tensor(drive.velocity[b], device=device) * frt[:, None]
        he = torch.as_tensor(drive.half[b], device=device)
        o_loc = (org - centre)[:, None, :]  # (F, 1, 3)
        t1 = (-he - o_loc) * inv
        t2 = (he - o_loc) * inv
        t_near = torch.minimum(t1, t2).amax(-1)
        t_far = torch.maximum(t1, t2).amin(-1)
        hit = (t_near <= t_far) & (t_near > 0)
        best = torch.minimum(best, torch.where(hit, t_near, math.inf))
    return torch.where(best <= max_range, best, math.inf)


def scans(drive: scene.Drive, frames, rig: dict, intr, w: int, h: int,
          device) -> list:
    """The scans (N, 4) float32 numpy of ``frames`` (a chunk that fits the
    device: F x R x 3 doubles a temporary)."""
    fx, fy, cx, cy = intr
    d = directions(rig, intr, w)
    dirs_v = torch.as_tensor(d, dtype=torch.float64, device=device)
    t = _cast(drive, frames, dirs_v, float(rig["max_range_m"]), device)
    pts = dirs_v[None] * t[..., None]  # (F, R, 3), velodyne frame
    v2c = torch.as_tensor(VELO_TO_CAM, dtype=torch.float64, device=device)
    cam = pts @ v2c[:3, :3].T + v2c[:3, 3]
    z = cam[..., 2]
    zs = torch.where(z > 0, z, 1.0)
    col = torch.round(cam[..., 0] / zs * fx + cx)
    row = torch.round(cam[..., 1] / zs * fy + cy)
    keep = torch.isfinite(t) & (z > 0) & (col >= 0) & (col < w) \
        & (row >= 0) & (row < h)
    out = []
    cap = int(rig["max_points"])
    pts32 = pts.float()
    for i in range(len(frames)):
        p = pts32[i][keep[i]].cpu().numpy()
        if len(p) > cap:
            p = p[np.linspace(0, len(p) - 1, cap).astype(np.int64)]
        out.append(np.concatenate(
            [p, np.full((len(p), 1), REFLECTANCE, np.float32)], 1))
    return out


def write(folder: str, drive: scene.Drive, rig: dict, intr, w: int, h: int,
          device, chunk: int = 16) -> tuple:
    """``velodyne/%06d.bin`` under ``folder`` for every frame of
    ``drive``: (points written, bytes written)."""
    os.makedirs(os.path.join(folder, "velodyne"), exist_ok=True)
    n_pts = n_bytes = 0
    n = len(drive.poses)
    for a in range(0, n, chunk):
        frames = list(range(a, min(a + chunk, n)))
        for f, p in zip(frames, scans(drive, frames, rig, intr, w, h,
                                      device)):
            p.tofile(os.path.join(folder, "velodyne", f"{f:06d}.bin"))
            n_pts += len(p)
            n_bytes += p.nbytes
    return n_pts, n_bytes
