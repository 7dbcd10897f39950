"""Stereo egomotion: batched RANSAC + Gauss-Newton on reprojection error
— the port of ``dynslam_tpu/ops/egomotion.py`` (libviso2's
``estimateMotion`` role).

The twist is viso2's (rx, ry, rz, tx, ty, tz) with R = Rx Ry Rz; the
estimate maps previous-frame camera coordinates to current-frame ones, so
callers compose ``new_pose = delta @ old_pose``.

RANSAC draws 3 distinct valid matches per hypothesis. ``jax.random``'s
Gumbel draws cannot be reproduced in PyTorch, so ``estimate_motion``
takes the draws as an optional ``sample_ids`` (iters, 3) input; by
default it draws them (Gumbel top-3, i.e. sampling without replacement)
from a ``torch.Generator``. The Jacobian of the residuals is written out
analytically where the JAX package used ``jax.jacfwd``.

``estimate_motion_many`` dispatches on the device of ``flow``: CPU tensors
take the plain version ``estimate_motion_many_plain``; CUDA tensors take
the two kernels of ``csrc/egomotion.cu`` (RANSAC hypotheses and inlier
counts, then the Gauss-Newton/IRLS refinement of the best one), and a
failed build or launch raises. The draws stay in PyTorch, before the
kernels, so both versions refine the same hypotheses and leave the
generator in the same state. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dynslam_tpu_torch.config import VisualOdometryParams
from dynslam_tpu_torch.ops import cuda_build
from dynslam_tpu_torch.utils import se3

#: kernel launches of ``estimate_motion_many`` on CUDA tensors (two a call)
launches = 0


class MotionEstimate(NamedTuple):
    tr: torch.Tensor  # (6,) viso2-style twist
    matrix: torch.Tensor  # (4, 4) T_cur<-prev
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int64
    success: torch.Tensor  # () bool


def triangulate_prev(flow: torch.Tensor, fx, cu, cv, baseline):
    """Previous-frame 3-D points from the stereo pair (viso2 convention)."""
    u1p, v1p, u2p = flow[..., 4], flow[..., 5], flow[..., 6]
    d = torch.clamp(u1p - u2p, min=1e-3)
    return torch.stack([(u1p - cu) * baseline / d, (v1p - cv) * baseline / d,
                        fx * baseline / d], -1)


def _rotation_and_derivs(tr: torch.Tensor):
    """R = Rx Ry Rz and dR/d(rx, ry, rz), each (..., 3, 3)."""
    rx, ry, rz = tr[..., 0], tr[..., 1], tr[..., 2]
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    o, z = torch.ones_like(rx), torch.zeros_like(rx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat([[o, z, z], [z, cx, -sx], [z, sx, cx]])
    Ry = mat([[cy, z, sy], [z, o, z], [-sy, z, cy]])
    Rz = mat([[cz, -sz, z], [sz, cz, z], [z, z, o]])
    dRx = mat([[z, z, z], [z, -sx, -cx], [z, cx, -sx]])
    dRy = mat([[-sy, z, cy], [z, z, z], [-cy, z, -sy]])
    dRz = mat([[-sz, -cz, z], [cz, -sz, z], [z, z, z]])
    return Rx @ Ry @ Rz, (dRx @ Ry @ Rz, Rx @ dRy @ Rz, Rx @ Ry @ dRz)


def _residuals(tr, pts, flow, fx, cu, cv, baseline, jacobian=False):
    """Residuals (..., N, 4) — current left (u, v), current right (u, v) —
    and, with ``jacobian``, their derivative (..., N, 4, 6)."""
    R, dR = _rotation_and_derivs(tr)
    p = pts @ R.transpose(-1, -2) + tr[..., None, 3:6]
    zc = torch.clamp(p[..., 2], min=1e-3)
    ul = fx * p[..., 0] / zc + cu
    vl = fx * p[..., 1] / zc + cv
    ur = fx * (p[..., 0] - baseline) / zc + cu
    r = torch.stack([ul - flow[..., 0], vl - flow[..., 1],
                     ur - flow[..., 2], vl - flow[..., 3]], -1)
    if not jacobian:
        return r
    # dp/dtr: (..., N, 3, 6) — rotation columns dR X, translation I
    dp_rot = torch.stack([pts @ d.transpose(-1, -2) for d in dR], -1)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    dp = torch.cat([dp_rot, eye.expand(*dp_rot.shape[:-1], 3)], -1)
    dz = dp[..., 2, :] * (p[..., 2] > 1e-3)[..., None].to(pts.dtype)
    z2 = (zc * zc)[..., None]
    d_ul = fx * dp[..., 0, :] / zc[..., None] - fx * p[..., 0, None] * dz / z2
    d_vl = fx * dp[..., 1, :] / zc[..., None] - fx * p[..., 1, None] * dz / z2
    d_ur = fx * dp[..., 0, :] / zc[..., None] \
        - fx * (p[..., 0, None] - baseline) * dz / z2
    return r, torch.stack([d_ul, d_vl, d_ur, d_vl], -2)


def _chol_solve6(A: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve batched 6x6 SPD systems by unrolled Cholesky; the pivot is
    clamped at 1e-12 so degenerate samples give large but finite deltas."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def _gn_solve(tr, pts, flow, weights, fx, cu, cv, baseline, iters: int):
    """Damped Gauss-Newton with per-match weights (0 disables a match),
    batched over leading axes of ``tr``."""
    eye6 = 1e-6 * torch.eye(6, dtype=tr.dtype, device=tr.device)
    for _ in range(iters):
        r, J = _residuals(tr, pts, flow, fx, cu, cv, baseline, jacobian=True)
        wgt = weights[..., None]
        r = (r * wgt).flatten(-2)  # (..., 4N)
        J = (J * wgt[..., None]).flatten(-3, -2)  # (..., 4N, 6)
        Jt = J.transpose(-1, -2)
        A = Jt @ J + eye6
        g = (Jt @ r[..., None])[..., 0]
        delta = _chol_solve6(A, g)
        ok = torch.isfinite(delta).all(-1) & (torch.linalg.norm(delta, dim=-1)
                                              < 10.0)
        tr = torch.where(ok[..., None], tr - delta, tr)
    return tr


def draw_sample_ids(valid: torch.Tensor, iters: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """(..., iters, 3) distinct valid match indices per hypothesis for
    (..., N) ``valid``: Gumbel top-3 over the valid matches (argmax
    passes, first index on ties)."""
    n = valid.shape[-1]
    u = torch.rand(*valid.shape[:-1], iters, n, generator=generator,
                   device=valid.device)
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    g = torch.where(valid[..., None, :], g, float("-inf"))
    lane = torch.arange(n, device=valid.device)
    ids = []
    for _ in range(3):
        i = torch.argmax(g, dim=-1)
        ids.append(i)
        g = torch.where(lane == i[..., None], float("-inf"), g)
    return torch.stack(ids, -1)


def _pick(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x[k, best[k]] for (K, iters, ...) ``x`` and (K,) ``best``, on the
    device (indexing with a tensor index read on the host would sync)."""
    idx = best.view(-1, 1, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(-1, 1, *x.shape[2:]))[:, 0]


def estimate_motion_many_plain(
    flow: torch.Tensor,  # (K, N, 8) RawFlow rows, one set per mask
    valid: torch.Tensor,  # (K, N) bool
    calib_vec: torch.Tensor,  # (4,): fx, cu, cv, baseline
    initial_tr: torch.Tensor,  # (K, 6) warm starts
    params: VisualOdometryParams,
    generator: Optional[torch.Generator] = None,
    sample_ids: Optional[torch.Tensor] = None,  # (K, iters, 3) int
) -> MotionEstimate:
    """K independent estimates in one batch — the counterpart of the JAX
    package's ``jax.vmap`` of ``estimate_motion`` over mask slots — in
    plain PyTorch. Every field of the result has a leading K axis."""
    fx, cu, cv, baseline = (calib_vec[0], calib_vec[1], calib_vec[2],
                            calib_vec[3])
    pts = triangulate_prev(flow, fx, cu, cv, baseline)  # (K, N, 3)
    vweights = valid.to(torch.float32)
    n_valid = vweights.sum(-1)
    # viso2-style column weighting: matches near the principal column
    # carry more weight
    col_w = 1.0 / ((flow[..., 4] - cu).abs() / cu.abs() + 0.05)

    if sample_ids is None:
        sample_ids = draw_sample_ids(valid, params.ransac_iters, generator)
    sample_ids = sample_ids.to(device=flow.device, dtype=torch.int64)
    K, iters = sample_ids.shape[:2]

    def rows(x):  # (K, N, ...) -> (K, iters, 3, ...) at the draws
        flat = sample_ids.reshape(K, -1)
        idx = flat.view(K, -1, *([1] * (x.dim() - 2))).expand(
            -1, -1, *x.shape[2:])
        return x.gather(1, idx).reshape(K, iters, 3, *x.shape[2:])

    trs = _gn_solve(initial_tr[:, None].expand(K, iters, 6), rows(pts),
                    rows(flow), rows(vweights), fx, cu, cv, baseline,
                    iters=6)  # (K, iters, 6)

    thresh = params.inlier_threshold_px ** 2 * 4.0

    def inliers(tr, p, f, v):
        r = _residuals(tr, p, f, fx, cu, cv, baseline)
        return ((r * r).sum(-1) < thresh) & v

    # every hypothesis at once: (K, iters, N)
    inl_masks = inliers(trs, pts[:, None], flow[:, None], valid[:, None])
    # first maximum, as jnp.argmax
    best = torch.argmax(inl_masks.sum(-1), dim=-1)  # (K,)
    w_base = _pick(inl_masks, best).to(torch.float32) * col_w
    tr_final = _gn_solve(_pick(trs, best), pts, flow, w_base,
                         fx, cu, cv, baseline, iters=params.gn_iters)

    # Tukey-biweight IRLS rounds; a mask keeps its previous weights when a
    # round would leave it fewer than 6 supported matches
    c2 = params.tukey_c_px * params.tukey_c_px
    w_prev = w_base
    for _ in range(params.irls_rounds):
        r = _residuals(tr_final, pts, flow, fx, cu, cv, baseline)
        rn2 = (r * r).sum(-1) / c2
        wt = w_base * torch.square(torch.clamp(1.0 - rn2, min=0.0))
        wt = torch.where((wt > 0.0).sum(-1, keepdim=True) >= 6, wt, w_prev)
        tr_final = _gn_solve(tr_final, pts, flow, wt, fx, cu, cv, baseline,
                             iters=4)
        w_prev = wt
    final_inl = inliers(tr_final, pts, flow, valid)
    num_inl = final_inl.sum(-1)

    success = (n_valid >= 6) & (num_inl >= 6) \
        & torch.isfinite(tr_final).all(-1)
    T = se3.twist_to_transform(tr_final)
    tr_final = torch.where(success[:, None], tr_final,
                           torch.zeros_like(tr_final))
    T = torch.where(success[:, None, None], T,
                    torch.eye(4, dtype=T.dtype, device=T.device))
    return MotionEstimate(tr_final, T, final_inl, num_inl, success)


def _check_args(flow, valid, calib_vec, initial_tr, sample_ids) -> None:
    """Raise ValueError on what the kernels do not take: ``flow`` float32
    (K, N, 8) with unit stride along its rows; ``valid`` bool (K, N) and
    ``calib_vec`` float32 (4,), both contiguous; ``initial_tr`` float32
    (K, 6) with unit stride along its rows; ``sample_ids`` (K, iters, 3)
    int32 or int64 and contiguous; K, N and iters at least 1; all but the
    draws on ``flow``'s device."""
    if flow.dim() != 3 or flow.shape[2] != 8 or flow.dtype != torch.float32:
        raise ValueError("estimate_motion_many: flow must be float32 "
                         f"(K, N, 8), got {flow.dtype} {tuple(flow.shape)}")
    K, N = flow.shape[:2]
    if K < 1 or N < 1:
        raise ValueError("estimate_motion_many: K and N must be at least 1")
    if valid.shape != (K, N) or valid.dtype != torch.bool:
        raise ValueError(f"estimate_motion_many: valid must be bool {(K, N)}"
                         f", got {valid.dtype} {tuple(valid.shape)}")
    if calib_vec.shape != (4,) or calib_vec.dtype != torch.float32:
        raise ValueError("estimate_motion_many: calib_vec must be float32 "
                         "(4,)")
    if initial_tr.shape != (K, 6) or initial_tr.dtype != torch.float32:
        raise ValueError("estimate_motion_many: initial_tr must be float32 "
                         f"{(K, 6)}, got {initial_tr.dtype} "
                         f"{tuple(initial_tr.shape)}")
    if sample_ids is not None and (
            sample_ids.dim() != 3 or sample_ids.shape[0] != K
            or sample_ids.shape[1] < 1 or sample_ids.shape[2] != 3
            or sample_ids.dtype not in (torch.int32, torch.int64)):
        raise ValueError("estimate_motion_many: sample_ids must be int32 or "
                         f"int64 ({K}, iters, 3), got {sample_ids.dtype} "
                         f"{tuple(sample_ids.shape)}")
    for name, t in (("valid", valid), ("calib_vec", calib_vec),
                    ("initial_tr", initial_tr)):
        if t.device != flow.device:
            raise ValueError(f"estimate_motion_many: {name} on {t.device}, "
                             f"flow on {flow.device}")
    # the kernels read a row's elements one after another; rows and slots
    # may lie at any stride (the staged pipeline's flow is a view of a
    # packed upload, the dynamic step's warm starts one of a wider table)
    if flow.stride(2) != 1 or initial_tr.stride(1) != 1 \
            or not valid.is_contiguous() or not calib_vec.is_contiguous() \
            or (sample_ids is not None and not sample_ids.is_contiguous()):
        raise ValueError("estimate_motion_many: flow and initial_tr need "
                         "unit stride along their rows, valid, calib_vec "
                         "and sample_ids must be contiguous")


def reduction_orders(K: int, iters: int, N: int):
    """The orders in which the plain version's cuBLAS products sum on the
    card, as the kernels reproduce them (``csrc/egomotion.cu``'s note):
    (``jtr_strided``: a hypothesis' J^T r as even and odd rows rather than
    two blocks of 6; ``jtj_chunks``: the split-K chunks of the
    refinement's J^T J; ``gemv_blocks``: 0 where the refinement's J^T r is
    a warp's 32 strided chains, else its number of blocks of 128 leaves).
    Measured on an H100 with CUDA 12.8's cuBLAS at K 1-16 slots of 256
    matches and 200 hypotheses and at K 1 of 2048 and 500: the batched
    products choose by batch size, a single slot's refinement splits K.
    Elsewhere they are the nearest rule, and the kernels may round
    otherwise than the plain version."""
    rows = 4 * N
    jtr_strided = 1400 <= K * iters <= 2800
    if K > 1:
        return jtr_strided, 1, 0
    jtj_chunks = max(1, rows // 32) if rows <= 1024 else 128
    return jtr_strided, jtj_chunks, min(-(-rows // 128), 31)


class _Launches(NamedTuple):
    """The kernels' two C calls, prepared (``cuda_build.Launch``), and the
    estimate they write."""

    hypotheses: cuda_build.Launch
    refine: cuda_build.Launch
    out: MotionEstimate


def launch_args(flow, valid, calib_vec, initial_tr, sample_ids,
                params: VisualOdometryParams) -> _Launches:
    """The two kernels' C calls over ``flow``'s K slots with the draws
    ``sample_ids`` (int64 on the device), ready to run in order on the
    current stream, and the outputs and scratch they fill (no launch)."""
    dev = flow.device
    K, N = valid.shape
    iters = sample_ids.shape[1]
    f32 = torch.float32
    jtr_strided, jtj_chunks, gemv_blocks = reduction_orders(K, iters, N)
    trs = torch.empty(K, iters, 6, dtype=f32, device=dev)
    counts = torch.empty(K, iters, dtype=torch.int32, device=dev)
    weights = torch.empty(K, 3, N, dtype=f32, device=dev)
    out = MotionEstimate(
        torch.empty(K, 6, dtype=f32, device=dev),
        torch.empty(K, 4, 4, dtype=f32, device=dev),
        torch.empty(K, N, dtype=torch.bool, device=dev),
        torch.empty(K, dtype=torch.int64, device=dev),
        torch.empty(K, dtype=torch.bool, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the plain version compares the squared residual sum with a float32
    # threshold and divides by c^2 as PyTorch divides a CUDA tensor by a
    # Python scalar: a product with its float32 reciprocal
    thresh = float(params.inlier_threshold_px ** 2 * 4.0)
    c2 = np.float32(params.tukey_c_px * params.tukey_c_px)
    inv_c2 = float(np.float32(1.0) / c2)
    slot_stride, row_stride = flow.stride(0), flow.stride(1)
    fa = cuda_build.function("egomotion", "dynslam_egomotion_hypotheses",
                             "p ii ppp i p iii f i pp p")
    fb = cuda_build.function("egomotion", "dynslam_egomotion_refine",
                             "p ii pppp iii ff iiii p ppppp p")
    hyp = cuda_build.Launch(fa, (
        flow.data_ptr(), slot_stride, row_stride, valid.data_ptr(),
        calib_vec.data_ptr(), initial_tr.data_ptr(), initial_tr.stride(0),
        sample_ids.data_ptr(), K, N, iters, thresh, int(jtr_strided),
        trs.data_ptr(), counts.data_ptr(), stream),
        (flow, valid, calib_vec, initial_tr, sample_ids, trs, counts))
    ref = cuda_build.Launch(fb, (
        flow.data_ptr(), slot_stride, row_stride, valid.data_ptr(),
        calib_vec.data_ptr(), trs.data_ptr(), counts.data_ptr(), K, N, iters,
        thresh, inv_c2, params.gn_iters, params.irls_rounds, jtj_chunks,
        gemv_blocks, weights.data_ptr(), *(t.data_ptr() for t in out),
        stream), (flow, valid, calib_vec, trs, counts, weights, *out))
    return _Launches(hyp, ref, out)


def estimate_motion_many(
    flow: torch.Tensor,  # (K, N, 8) RawFlow rows, one set per mask
    valid: torch.Tensor,  # (K, N) bool
    calib_vec: torch.Tensor,  # (4,): fx, cu, cv, baseline
    initial_tr: torch.Tensor,  # (K, 6) warm starts
    params: VisualOdometryParams,
    generator: Optional[torch.Generator] = None,
    sample_ids: Optional[torch.Tensor] = None,  # (K, iters, 3) int
) -> MotionEstimate:
    """K independent estimates in one batch (``estimate_motion_many_plain``
    for its rule). CPU tensors: the plain version; CUDA tensors: the two
    kernels of ``csrc/egomotion.cu`` after the draws, two launches, no
    host sync. The arguments are checked first on either device."""
    global launches
    _check_args(flow, valid, calib_vec, initial_tr, sample_ids)
    dev = flow.device
    if dev.type == "cpu":
        return estimate_motion_many_plain(flow, valid, calib_vec, initial_tr,
                                          params, generator, sample_ids)
    if dev.type != "cuda":
        raise ValueError(f"estimate_motion_many: unsupported device {dev}")
    if sample_ids is None:
        sample_ids = draw_sample_ids(valid, params.ransac_iters, generator)
    ids = sample_ids.to(device=dev, dtype=torch.int64)
    run = launch_args(flow, valid, calib_vec, initial_tr, ids, params)
    cuda_build.check_launch(run.hypotheses(), "egomotion hypotheses")
    launches += 1
    cuda_build.check_launch(run.refine(), "egomotion refine")
    launches += 1
    return run.out


def estimate_motion(
    flow: torch.Tensor,  # (N, 8) RawFlow rows
    valid: torch.Tensor,  # (N,) bool
    calib_vec: torch.Tensor,  # (4,): fx, cu, cv, baseline
    initial_tr: torch.Tensor,  # (6,) warm start
    params: VisualOdometryParams,
    generator: Optional[torch.Generator] = None,
    sample_ids: Optional[torch.Tensor] = None,  # (iters, 3) int
) -> MotionEstimate:
    """One estimate: ``estimate_motion_many`` at K = 1."""
    est = estimate_motion_many(
        flow[None], valid[None], calib_vec, initial_tr[None], params,
        generator=generator,
        sample_ids=None if sample_ids is None else sample_ids[None])
    return MotionEstimate(*(x[0] for x in est))
