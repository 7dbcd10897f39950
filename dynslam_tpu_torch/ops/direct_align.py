"""Direct (dense photometric) pose refinement — the port of
``dynslam_tpu/ops/direct_align.py``, the equivalent of the reference's
``src/DynSLAM/Direct/`` module. The reference ships that module disabled
(CMakeLists.txt:115-129, InstanceReconstructor.cpp:460-566; "does NOT
help improve pose estimates", Direct/README.md:7); the staged pipeline
calls it only with ``use_direct_refinement``.

Coarse-to-fine Gauss-Newton on the photometric error of the reference
frame's pixels (those with depth) warped into the target frame, with
pseudo-Huber weights: a fixed number of iterations a pyramid level, the
Jacobian by forward-mode differentiation (``torch.func.jacfwd``, JAX's
``jax.jacfwd``), a step taken only where it is finite and shorter than 1
(``torch.where``), so the loop never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd

from dynslam_tpu_torch.device import DeviceLike, resolve_device
from dynslam_tpu_torch.utils import se3


class DirectAlignResult(NamedTuple):
    xi: torch.Tensor  # (6,) refined twist (se(3), exponential map)
    T: torch.Tensor  # (4, 4) refined T_target<-ref
    residual_rms: torch.Tensor  # robust RMS photometric error at xi
    valid_fraction: torch.Tensor  # share of pixels contributing


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    ax, ay = x - x0, y - y0
    return (img[y0, x0] * (1 - ax) * (1 - ay)
            + img[y0, x0 + 1] * ax * (1 - ay)
            + img[y0 + 1, x0] * (1 - ax) * ay
            + img[y0 + 1, x0 + 1] * ax * ay)


def _downsample(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    return img[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2) \
        .mean((1, 3))


def _downsample_depth(d: torch.Tensor) -> torch.Tensor:
    """The depth pyramid: the mean of the valid samples only."""
    h, w = d.shape
    q = d[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2)
    valid = (q > 0).sum((1, 3))
    return torch.where(valid > 0, q.sum((1, 3)) / torch.clamp(valid, min=1),
                       0.0)


def _align_level(ref_gray, ref_depth, tgt_gray, intr, xi0, iters: int = 10,
                 huber_delta: float = 8.0):
    """``iters`` Gauss-Newton steps at one pyramid level. Returns (xi, the
    RMS residual, the share of pixels contributing)."""
    h, w = ref_gray.shape
    dev = ref_gray.device
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    valid = ref_depth > 0
    z = torch.where(valid, ref_depth, 1.0)
    pts = torch.stack([(uu - cx) / fx * z, (vv - cy) / fy * z, z],
                      -1).reshape(-1, 3)
    ref_i = ref_gray.reshape(-1)
    vmask = valid.reshape(-1)

    def residuals(xi):
        # as a batch of one: in forward-mode AD a 0-dim tensor combined
        # with a Python scalar takes a float64 tangent
        T = se3.exp_se3(xi[None])[0]
        pc = pts @ T[:3, :3].T + T[:3, 3]
        zc = torch.clamp(pc[:, 2], min=0.05)
        u = pc[:, 0] / zc * fx + cx
        v = pc[:, 1] / zc * fy + cy
        ok = vmask & (u >= 1) & (u < w - 2) & (v >= 1) & (v < h - 2) \
            & (pc[:, 2] > 0.05)
        r = torch.where(ok, _bilinear(tgt_gray, u, v) - ref_i, 0.0)
        return r, (r, ok)

    jac = jacfwd(residuals, has_aux=True)
    eye6 = 1e-5 * torch.eye(6, dtype=torch.float32, device=dev)
    xi = xi0
    for _ in range(iters):
        J, (r, ok) = jac(xi)  # (N, 6)
        # pseudo-Huber IRLS weights (the reference's robust loss family)
        wgt = torch.where(ok, 1.0 / torch.sqrt(1.0 + (r / huber_delta) ** 2),
                          0.0)
        Jw = J * wgt[:, None]
        delta, _ = torch.linalg.solve_ex(Jw.T @ J + eye6, Jw.T @ r)
        ok_step = torch.isfinite(delta).all() & (torch.linalg.norm(delta)
                                                 < 1.0)
        xi = torch.where(ok_step, xi - delta, xi)
    r, ok = residuals(xi)[1]
    n_ok = ok.sum()
    rms = torch.sqrt((r * r).sum() / torch.clamp(n_ok, min=1))
    return xi, rms, n_ok / vmask.shape[0]


def refine_pose(
    ref_gray,
    ref_depth_m,
    tgt_gray,
    intrinsics: Tuple[float, float, float, float],
    T_init=None,
    levels: int = 3,
    iters_per_level: int = 8,
    device: DeviceLike = None,
) -> DirectAlignResult:
    """Refine T_target<-ref by coarse-to-fine photometric alignment of
    (H, W) gray images and the reference's depth (m, 0 = none), numpy or
    tensors, on ``device`` (CUDA unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

    ref_gray, tgt_gray, ref_depth = f32(ref_gray), f32(tgt_gray), \
        f32(ref_depth_m)
    xi = se3.log_se3(f32(T_init)) if T_init is not None \
        else torch.zeros(6, dtype=torch.float32, device=dev)
    K = f32(intrinsics)
    pyr = [(ref_gray, ref_depth, tgt_gray, K)]
    for _ in range(levels - 1):
        g, d, t, K = pyr[-1]
        pyr.append((_downsample(g), _downsample_depth(d), _downsample(t),
                    torch.stack([K[0] / 2, K[1] / 2, (K[2] + 0.5) / 2 - 0.5,
                                 (K[3] + 0.5) / 2 - 0.5])))
    for g, d, t, K in reversed(pyr):
        xi, rms, frac = _align_level(g, d, t, K, xi, iters=iters_per_level)
    return DirectAlignResult(xi=xi, T=se3.exp_se3(xi), residual_rms=rms,
                             valid_fraction=frac)
