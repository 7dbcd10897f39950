"""Frozen copy of ``dynslam_tpu_torch/utils/se3.py`` for the benchmark's plain
reference, which imports nothing of the port. Its docstring follows.

SE(3) utilities on tensors — the port of ``dynslam_tpu/utils/se3.py``.

Twists follow the viso2 parameterization where relevant: (rx, ry, rz,
tx, ty, tz) with R = Rx(rx) @ Ry(ry) @ Rz(rz), not the exponential map,
because the reference's motion estimator composes Euler-angle rotations
(libviso2 ``transformationVectorToMatrix``). Every function takes a
leading batch shape where the JAX package used ``vmap``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference._util import constant


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], z, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def _eye3(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        *w.shape[:-1], 3, 3
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation exponential of (..., 3) axis-angle vectors."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = hat(w / theta[..., None])
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    R = _eye3(w) + s * K + (1.0 - c) * (K @ K)
    small = (theta2 < 1e-12)[..., None, None]
    return torch.where(small, _eye3(w) + hat(w), R)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4). Built by concatenation:
    writing the constant 1 into a CUDA tensor element would copy it from
    host memory, which waits for the stream."""
    bottom = constant((0.0, 0.0, 0.0, 1.0), R.dtype, R.device)
    top = torch.cat([R, t[..., None]], -1)
    return torch.cat([top, bottom.expand(*R.shape[:-2], 1, 4)], -2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) = (w, v) -> (..., 4, 4) (true exponential)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    K = hat(w / theta[..., None])
    th = theta[..., None, None]
    s, c = torch.sin(th), torch.cos(th)
    KK = K @ K
    R = _eye3(w) + s * K + (1.0 - c) * KK
    V = _eye3(w) + (1.0 - c) / th * K + (th - s) / th * KK
    small = (theta2 < 1e-12)[..., None, None]
    R = torch.where(small, _eye3(w) + hat(w), R)
    V = torch.where(small, _eye3(w) + 0.5 * hat(w), V)
    return make_transform(R, (V @ v[..., None])[..., 0])


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) rotation vector."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    w_hat = (R - R.transpose(-1, -2)) / 2.0
    w = torch.stack([w_hat[..., 2, 1], w_hat[..., 0, 2], w_hat[..., 1, 0]],
                    -1)
    s = torch.sin(theta)
    scale = torch.where(s.abs() < 1e-7, 1.0, theta / (s + 1e-32))
    return w * scale[..., None]


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> (..., 6) se(3) twist (w, v)."""
    w = log_so3(T[..., :3, :3])
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    K = hat(w / theta[..., None])
    half = (theta / 2.0)[..., None, None]
    cot_term = half * torch.cos(half) / (torch.sin(half) + 1e-32)
    small = _eye3(w) - 0.5 * hat(w)
    V_inv = small + (1.0 - cot_term) * (K @ K)
    V_inv = torch.where((theta2 < 1e-12)[..., None, None], small, V_inv)
    return torch.cat([w, (V_inv @ T[..., :3, 3:4])[..., 0]], -1)


def euler_to_rot(rx, ry, rz) -> torch.Tensor:
    """viso2-style rotation R = Rx @ Ry @ Rz for same-shaped angle tensors;
    returns (..., 3, 3)."""
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    o, z = torch.ones_like(rx), torch.zeros_like(rx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat([[o, z, z], [z, cx, -sx], [z, sx, cx]])
    Ry = mat([[cy, z, sy], [z, o, z], [-sy, z, cy]])
    Rz = mat([[cz, -sz, z], [sz, cz, z], [z, z, o]])
    return Rx @ Ry @ Rz


def twist_to_transform(tr: torch.Tensor) -> torch.Tensor:
    """viso2 ``transformationVectorToMatrix``: (..., 6) -> (..., 4, 4)."""
    R = euler_to_rot(tr[..., 0], tr[..., 1], tr[..., 2])
    return make_transform(R, tr[..., 3:6])


def np_twist_to_transform(tr) -> np.ndarray:
    """Host-numpy ``twist_to_transform`` of one (6,) twist, in float64 —
    the tracker's bookkeeping form."""
    rx, ry, rz, tx, ty, tz = (float(v) for v in tr)
    sx, cx = np.sin(rx), np.cos(rx)
    sy, cy = np.sin(ry), np.cos(ry)
    sz, cz = np.sin(rz), np.cos(rz)
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]])
    Ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    Rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    T = np.eye(4)
    T[:3, :3] = Rx @ Ry @ Rz
    T[:3, 3] = (tx, ty, tz)
    return T


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse (R^T, -R^T t) of (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle of (..., 3, 3), KITTI-style."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
