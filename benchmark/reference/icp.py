"""Frozen copy of ``dynslam_tpu_torch/ops/icp.py`` for the benchmark's plain
reference, which imports nothing of the port. Its docstring follows.

Projective point-to-plane ICP — the port of ``dynslam_tpu/ops/icp.py``
(InfiniTAM's ITMDepthTracker role), the static step's fallback when
sparse VO fails.

The reference is the previous frame's raycast (frame-to-model). Current
depth is back-projected at a stride, moved by the pose estimate,
associated projectively into the reference view, and a Huber-weighted
point-to-plane system (6x6) is solved per Gauss-Newton step, with a
left-multiplied world-frame twist on cam_to_world.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import se3


class IcpResult(NamedTuple):
    world_to_cam: torch.Tensor  # (4, 4) refined pose
    num_inliers: torch.Tensor  # () int64
    mean_residual: torch.Tensor  # () f32 (m)
    success: torch.Tensor  # () bool


def normals_from_points(points: torch.Tensor, hit: torch.Tensor):
    """Image-space normals of a raycast point map: cross products of
    central differences (wrapping at the borders, as ``jnp.roll``)."""
    du = torch.roll(points, -1, 1) - torch.roll(points, 1, 1)
    dv = torch.roll(points, -1, 0) - torch.roll(points, 1, 0)
    n = torch.linalg.cross(dv, du, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = torch.where(norm > 1e-9, n / torch.clamp(norm, min=1e-9), 0.0)
    return torch.where(hit[..., None], n, 0.0)


def _exp_twist(xi: torch.Tensor) -> torch.Tensor:
    """(6,) [w | v] -> 4x4: rotation exponential, first-order translation."""
    return se3.make_transform(se3.so3_exp(xi[:3]), xi[3:])


def icp_track(
    depth_m: torch.Tensor,  # (H, W) current depth, 0 = invalid
    ref_points: torch.Tensor,  # (H, W, 3) previous raycast points (world)
    ref_hit: torch.Tensor,  # (H, W) bool
    ref_world_to_cam: torch.Tensor,  # (4, 4) pose the reference was cast from
    init_world_to_cam: torch.Tensor,  # (4, 4) initial estimate
    intrinsics: torch.Tensor,  # (4,) fx, fy, cx, cy
    stride: int = 4,
    iters: int = 10,
    dist_threshold: float = 0.25,
    huber_delta: float = 0.02,
) -> IcpResult:
    # the whole solve runs in float64, its result is float32: in float32
    # the sums over the points and the association's rounding moved the
    # pose by up to ~5e-4 between the card and the CPU and between CPU
    # thread counts (KITTI-size frames, the street's weakly constrained
    # forward axis); in float64 the same inputs give the same pose on both
    out = depth_m.dtype
    depth_m, ref_points, ref_world_to_cam, init_world_to_cam, intrinsics = (
        x.to(torch.float64) for x in (depth_m, ref_points, ref_world_to_cam,
                                      init_world_to_cam, intrinsics))
    h, w = depth_m.shape
    dev = depth_m.device
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    ref_pn = torch.cat([ref_points, normals_from_points(ref_points, ref_hit)],
                       -1).reshape(-1, 6)

    d = depth_m[::stride, ::stride]
    hs, ws = d.shape
    vv = torch.arange(hs, dtype=torch.float64, device=dev)[:, None].expand(
        hs, ws) * stride
    uu = torch.arange(ws, dtype=torch.float64, device=dev)[None, :].expand(
        hs, ws) * stride
    valid_d = (d > 0.1).reshape(-1)
    pc = torch.stack([(uu - cx) / fx * d, (vv - cy) / fy * d, d],
                     -1).reshape(-1, 3)
    Rr, tr = ref_world_to_cam[:3, :3], ref_world_to_cam[:3, 3]
    eye6 = 1e-5 * torch.eye(6, dtype=torch.float64, device=dev)

    def associate(c2w):
        pw = pc @ c2w[:3, :3].T + c2w[:3, 3]
        pr = pw @ Rr.T + tr
        z = torch.clamp(pr[:, 2], min=1e-3)
        u = pr[:, 0] / z * fx + cx
        v = pr[:, 1] / z * fy + cy
        ui = torch.clamp(torch.round(u).to(torch.int64), 0, w - 1)
        vi = torch.clamp(torch.round(v).to(torch.int64), 0, h - 1)
        in_img = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) \
            & (pr[:, 2] > 0.1)
        pn = ref_pn[vi * w + ui]
        n = pn[:, 3:]
        diff = pw - pn[:, :3]
        ok = valid_d & in_img & ((n * n).sum(1) > 0.5) \
            & ((diff * diff).sum(1) < dist_threshold ** 2)
        return pw, n, (n * diff).sum(1), ok

    def gn_step(c2w):
        pw, n, r, ok = associate(c2w)
        ar = r.abs()
        wgt = torch.where(ar <= huber_delta, 1.0,
                          huber_delta / torch.clamp(ar, min=1e-9))
        wgt = torch.where(ok, wgt, 0.0)
        J = torch.cat([torch.linalg.cross(pw, n, dim=1), n], 1)  # [w | v]
        A = (J * wgt[:, None]).T @ J + eye6
        b = (J * wgt[:, None]).T @ r
        # the _ex solvers skip the error check and so the host sync
        dx = torch.linalg.solve_ex(A, b)[0]
        finite = torch.isfinite(dx).all() & (torch.linalg.norm(dx) < 1.0)
        dx = torch.where(finite, dx, torch.zeros_like(dx))
        return _exp_twist(-dx) @ c2w

    c2w = torch.linalg.inv_ex(init_world_to_cam)[0]
    # a second, shorter pass from the first's solution re-forms the
    # association set around the new pose
    for _ in range(iters + iters // 2):
        c2w = gn_step(c2w)

    _, _, r, ok = associate(c2w)
    num = ok.sum()
    mean_r = torch.where(ok, r.abs(), 0.0).sum() / torch.clamp(num, min=1)
    success = (num > 100) & (mean_r < 0.05) & torch.isfinite(c2w).all()
    w2c = torch.where(success, torch.linalg.inv_ex(c2w)[0], init_world_to_cam)
    return IcpResult(w2c.to(out), num, mean_r.to(out), success)
