"""Frozen copy of ``dynslam_tpu_torch/ops/features.py`` for the benchmark's plain
reference, which imports nothing of the port. Its docstring follows.

Sparse features and circular stereo-temporal matching — the port of
``dynslam_tpu/ops/features.py`` (libviso2's matcher role).

- detection: blob + corner 5x5 filters, NMS by max-pooling, bucketed
  per-class selection in (score descending, index ascending) order —
  ``torch.topk`` does not break ties by index, so selection uses a
  stable descending sort (the responses of integer images are integers
  and tie often);
- description: Sobel responses at a 4x4 stride-2 grid -> 32-dim f32,
  read with plain gathers;
- ``circular_match``: cur-left -> prev-left -> prev-right -> cur-right ->
  cur-left with epipolar / flow-window / class masks;
- ``refine_flow_quad``: Lucas-Kanade alignment of the rounded current-left
  patch into the other three images, sampling values and central-
  difference gradients bilinearly with the JAX package's tent weights in
  per-match window coordinates.

Flow rows follow the reference's RawFlow layout:
(u1c, v1c, u2c, v2c, u1p, v1p, u2p, v2p).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.config import VisualOdometryParams
from benchmark.reference._util import constant

_BLOB_KERNEL = [
    [-1, -1, -1, -1, -1],
    [-1, 1, 1, 1, -1],
    [-1, 1, 8, 1, -1],
    [-1, 1, 1, 1, -1],
    [-1, -1, -1, -1, -1],
]
_CORNER_KERNEL = [
    [-1, -1, 0, 1, 1],
    [-1, -1, 0, 1, 1],
    [0, 0, 0, 0, 0],
    [1, 1, 0, -1, -1],
    [1, 1, 0, -1, -1],
]
_SOBEL_X = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
_SOBEL_Y = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]

DESC_DIM = 32
#: detection threshold on |filter response| (uint8-scale images)
TAU = 25.0
#: border excluded from detection (descriptor + filter support)
MARGIN = 5
#: bucket side in px
BUCKET = 32


class Features(NamedTuple):
    """Fixed-size feature set; invalid slots have valid=False."""

    pos: torch.Tensor  # (K, 2) f32 (u, v)
    desc: torch.Tensor  # (K, 32) f32
    cls: torch.Tensor  # (K,) int64 in [0, 4)
    score: torch.Tensor  # (K,) f32
    valid: torch.Tensor  # (K,) bool


def _conv_same(img: torch.Tensor, kernels) -> torch.Tensor:
    """(B, H, W) images, C odd-sized integer kernels -> (B, C, H, W)
    cross-correlation with zero padding (``lax.conv`` SAME), as a sum of
    shifted copies: on uint8-valued images every partial sum is an exact
    float32 integer, whatever the order — a cuDNN convolution could run
    in TF32 and round them."""
    B, h, w = img.shape
    r = len(kernels[0]) // 2
    padded = F.pad(img, (r, r, r, r))
    out = []
    for k in kernels:
        acc = torch.zeros_like(img)
        for dy, row in enumerate(k):
            for dx, c in enumerate(row):
                if c:
                    acc = acc + c * padded[:, dy:dy + h, dx:dx + w]
        out.append(acc)
    return torch.stack(out, 1)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` order along the last axis: values descending, equal
    values by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_features(gray: torch.Tensor,
                    params: VisualOdometryParams) -> Features:
    """Detect up to ``params.max_candidates`` features on each of a batch
    of (B, H, W) f32 images; every field gains a leading batch axis."""
    B, h, w = gray.shape
    dev = gray.device
    per_class = params.max_candidates // 4
    resp = _conv_same(gray, [_BLOB_KERNEL, _CORNER_KERNEL])
    responses = torch.stack([resp[:, 0], -resp[:, 0], resp[:, 1],
                             -resp[:, 1]], 1)  # (B, 4, H, W)
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    border = (row < MARGIN) | (row >= h - MARGIN) | (col < MARGIN) \
        | (col >= w - MARGIN)
    responses = torch.where(border, float("-inf"), responses)

    n = params.nms_radius
    local_max = F.max_pool2d(responses, 2 * n + 1, stride=1, padding=n)
    is_peak = (responses >= local_max) & (responses > TAU)
    masked = torch.where(is_peak, responses, float("-inf"))

    # bucketed selection: the best bk of each 32x32 bucket, then the
    # global best per_class of those, per class
    bs = BUCKET
    hp, wp = -(-h // bs) * bs, -(-w // bs) * bs
    n_tiles = (hp // bs) * (wp // bs)
    bk = min(bs * bs, max(8, -(-2 * per_class // n_tiles)))
    padded = F.pad(masked, (0, wp - w, 0, hp - h), value=float("-inf"))
    tiles = padded.reshape(B, 4, hp // bs, bs, wp // bs, bs)
    tiles = tiles.permute(0, 1, 2, 4, 3, 5).reshape(B, 4, n_tiles, bs * bs)
    tscore, tidx = top_k_stable(tiles, bk)  # (B, 4, T, bk)
    tile_id = torch.arange(n_tiles, device=dev)[:, None]
    n_tiles_x = wp // bs
    ty = (tile_id // n_tiles_x) * bs + tidx // bs
    tx = (tile_id % n_tiles_x) * bs + tidx % bs
    cand_flat = (ty * w + torch.clamp(tx, max=w - 1)).reshape(B, 4, -1)
    cand_score = tscore.reshape(B, 4, -1)

    k_eff = min(per_class, cand_score.shape[-1])
    scores, sel = top_k_stable(cand_score, k_eff)
    flat_idx = torch.gather(cand_flat, 2, sel)
    if k_eff < per_class:
        pad = per_class - k_eff
        scores = F.pad(scores, (0, pad), value=float("-inf"))
        flat_idx = F.pad(flat_idx, (0, pad), value=0)
    yi = flat_idx // w
    xi = flat_idx % w

    # subpixel: 1-D parabolas through the response peak in x and y
    flat_resp = responses.reshape(B, 4, h * w)

    def resp_at(dy, dx):
        yy = torch.clamp(yi + dy, 0, h - 1)
        xx = torch.clamp(xi + dx, 0, w - 1)
        r = torch.gather(flat_resp, 2, yy * w + xx)
        return torch.where(torch.isfinite(r), r, scores)

    def parab(minus, center, plus):
        denom = minus - 2.0 * center + plus
        off = torch.where(denom.abs() > 1e-6,
                          0.5 * (minus - plus) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    xs = xi.to(torch.float32) + parab(resp_at(0, -1), scores, resp_at(0, 1))
    ys = yi.to(torch.float32) + parab(resp_at(-1, 0), scores, resp_at(1, 0))
    pos = torch.stack([xs.reshape(B, -1), ys.reshape(B, -1)], -1)
    score = scores.reshape(B, -1)
    valid = torch.isfinite(score)
    cls = torch.arange(4, device=dev).repeat_interleave(per_class)

    # descriptors: Sobel x / y at rows y0 + {0,2,4,6}, cols x0 + {0,2,4,6}
    # of the 8x8 window anchored (clipped) at the peak - 3
    sob = _conv_same(gray, [_SOBEL_X, _SOBEL_Y]).reshape(B, 2, h * w)
    y0 = torch.clamp(yi.reshape(B, -1) - 3, 0, h - 8)
    x0 = torch.clamp(xi.reshape(B, -1) - 3, 0, w - 8)
    g = torch.arange(0, 8, 2, device=dev)
    rr = y0[..., None, None] + g[:, None]  # (B, K, 4, 1)
    cc = x0[..., None, None] + g[None, :]  # (B, K, 1, 4)
    lin = (rr * w + cc).reshape(B, 1, -1).expand(B, 2, -1)
    samp = torch.gather(sob, 2, lin).reshape(B, 2, -1, 16)  # (B, 2, K, 16)
    desc = samp.permute(0, 2, 3, 1).reshape(B, -1, DESC_DIM)
    desc = torch.where(valid[..., None], desc, 0.0)
    pos = torch.where(valid[..., None], pos, -1e6)
    return Features(pos, desc, cls.expand(B, -1), score, valid)


def detect_features_pair(left_gray: torch.Tensor, right_gray: torch.Tensor,
                         params: VisualOdometryParams):
    """Detect on both images of a stereo pair in one batch; returns
    (Features_left, Features_right)."""
    both = detect_features(torch.stack([left_gray, right_gray]), params)
    return (Features(*(f[0] for f in both)), Features(*(f[1] for f in both)))


def circular_match(cur_left: Features, cur_right: Features,
                   prev_left: Features, prev_right: Features,
                   params: VisualOdometryParams):
    """4-image circular matching, the four directed matches batched.
    Returns (flow (K, 8), valid (K,))."""
    A = (cur_left, prev_left, prev_right, cur_right)
    Bf = (prev_left, prev_right, cur_right, cur_left)

    def stack(field, feats):
        return torch.stack([getattr(f, field) for f in feats])

    fa_desc, fb_desc = stack("desc", A), stack("desc", Bf)
    fa_pos, fb_pos = stack("pos", A), stack("pos", Bf)
    a2 = (fa_desc * fa_desc).sum(-1)[..., None]
    b2 = (fb_desc * fb_desc).sum(-1)[:, None, :]
    d2 = a2 + b2 - 2.0 * torch.bmm(fa_desc, fb_desc.transpose(1, 2))

    du = fa_pos[:, :, None, 0] - fb_pos[:, None, :, 0]
    dv = fa_pos[:, :, None, 1] - fb_pos[:, None, :, 1]
    band = params.epipolar_band_px
    maxd = params.max_disparity
    ok_flow = (du * du + dv * dv) <= params.flow_radius_px ** 2
    ok_l2r = (dv.abs() <= band) & (du > 0.1) & (du <= maxd)
    ok_r2l = (dv.abs() <= band) & (du < -0.1) & (du >= -maxd)
    # modes per pair: flow, stereo l->r, flow, stereo r->l
    ok = torch.stack([ok_flow[0], ok_l2r[1], ok_flow[2], ok_r2l[3]])
    ok &= stack("cls", A)[:, :, None] == stack("cls", Bf)[:, None, :]
    ok &= stack("valid", A)[:, :, None] & stack("valid", Bf)[:, None, :]
    cost = torch.where(ok, d2, float("inf"))
    best = torch.argmin(cost, dim=2)
    okm = torch.isfinite(cost.amin(2))

    j = best[0]
    k = best[1][j]
    l = best[2][k]
    m = best[3][l]
    K = cur_left.pos.shape[0]
    circle_ok = m == torch.arange(K, device=m.device)
    chain_ok = okm[0] & okm[1][j] & okm[2][k] & okm[3][l]

    u1c, v1c = cur_left.pos[:, 0], cur_left.pos[:, 1]
    u2c, v2c = cur_right.pos[l, 0], cur_right.pos[l, 1]
    u1p, v1p = prev_left.pos[j, 0], prev_left.pos[j, 1]
    u2p, v2p = prev_right.pos[k, 0], prev_right.pos[k, 1]
    disp_c = u1c - u2c
    disp_p = u1p - u2p
    geo_ok = (disp_c > 0.1) & (disp_p > 0.1) & (disp_c <= maxd) \
        & (disp_p <= maxd) & ((v1c - v2c).abs() <= band) \
        & ((v1p - v2p).abs() <= band)
    valid = circle_ok & chain_ok & geo_ok & cur_left.valid
    flow = torch.stack([u1c, v1c, u2c, v2c, u1p, v1p, u2p, v2p], -1)
    return torch.where(valid[:, None], flow, 0.0), valid


def refine_stereo_disparity(left_img: torch.Tensor, right_img: torch.Tensor,
                            u_left: torch.Tensor, v_left: torch.Tensor,
                            u_right: torch.Tensor,
                            radius: int = 3) -> torch.Tensor:
    """Subpixel right-image x of stereo matches: a parabola through the
    patch SADs at x-shifts -1, 0 and +1 (viso2's match.refinement=1),
    plus the left feature's own subpixel remainder, so that u_left -
    u_right measures the relative displacement. (M,) each; the JAX
    package's ``features.refine_stereo_disparity``, which has no caller."""
    h, w = left_img.shape
    ul = torch.round(u_left).to(torch.int64)
    vl = torch.round(v_left).to(torch.int64)
    ur = torch.round(u_right).to(torch.int64)
    offs = torch.arange(-radius, radius + 1, device=left_img.device)
    dy = offs.repeat_interleave(2 * radius + 1)  # row-major (dy, dx)
    dx = offs.repeat(2 * radius + 1)

    def patch(img, uc, shift: int):
        yy = torch.clamp(vl[:, None] + dy, 0, h - 1)
        xx = torch.clamp(uc[:, None] + dx + shift, 0, w - 1)
        return img[yy, xx]  # (M, P)

    pl = patch(left_img, ul, 0)
    sm, s0, sp = ((pl - patch(right_img, ur, s)).abs().sum(-1)
                  for s in (-1, 0, 1))
    denom = sm - 2.0 * s0 + sp
    off = torch.where(denom > 1e-6,
                      0.5 * (sm - sp) / torch.clamp(denom, min=1e-6), 0.0)
    off = torch.clamp(off, -1.0, 1.0)
    return ur.to(torch.float32) + off + (u_left - ul.to(torch.float32))


#: per-match LK window side: samples stay within 6.4 px of the rounded
#: centre, so a window anchored 8 px before it covers every read with
#: interior central differences
_LK_WIN = 18


def _gradients(img: torch.Tensor):
    """Central differences with one-sided edges (``jnp.gradient``)."""
    gy, gx = torch.gradient(img)
    return gx, gy


def _tent2(p: torch.Tensor):
    """Fractional window coordinates -> (lower index, its tent weight, the
    upper neighbour's tent weight), as the JAX package's tent sums."""
    p = torch.clamp(p, 0.0, _LK_WIN - 1.001)
    i0 = torch.floor(p)
    w0 = torch.clamp(1.0 - (p - i0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (p - (i0 + 1.0)).abs(), min=0.0)
    return i0.to(torch.int64), w0, w1


class _Windows:
    """One image's per-match windows: value and gradient planes read at
    window coordinates through plain gathers."""

    def __init__(self, img, gx, gy, ax, ay):
        self.w = img.shape[1]
        self.planes = torch.stack([img, gx, gy]).reshape(3, -1)
        self.ax, self.ay = ax, ay  # (K,) int64 window anchors

    def sample(self, xs, ys):
        """Bilinear (value, gx, gy) at image positions (K, P) each."""
        lx = xs - self.ax[:, None].to(torch.float32)
        ly = ys - self.ay[:, None].to(torch.float32)
        x0, wx0, wx1 = _tent2(lx)
        y0, wy0, wy1 = _tent2(ly)
        gx0 = self.ax[:, None] + x0
        gy0 = self.ay[:, None] + y0

        def at(yy, xx):
            return self.planes[:, (yy * self.w + xx).reshape(-1)].reshape(
                3, *xs.shape)

        r0 = wy0 * at(gy0, gx0) + wy1 * at(gy0 + 1, gx0)
        r1 = wy0 * at(gy0, gx0 + 1) + wy1 * at(gy0 + 1, gx0 + 1)
        out = r0 * wx0 + r1 * wx1
        return out[0], out[1], out[2]


def refine_flow_quad(cur_l, cur_r, prev_l, prev_r, flow: torch.Tensor,
                     radius: int = 3, iters: int = 3) -> torch.Tensor:
    """Align the rounded current-left patch into the current-right (x
    only), previous-left (x, y, scale) and previous-right (x at the
    refined previous row) images by Lucas-Kanade. Returns (K, 8)."""
    h, w = cur_l.shape
    dev = flow.device
    A = _LK_WIN // 2 - 1
    if radius * 1.3 + 2.5 > A:
        raise ValueError("patch radius too large for the LK window")
    offs = [(float(dy), float(dx)) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    off_dy = constant([o[0] for o in offs], torch.float32, dev)
    off_dx = constant([o[1] for o in offs], torch.float32, dev)

    ui = torch.round(flow[:, 0]).to(torch.int64)
    vi = torch.round(flow[:, 1]).to(torch.int64)
    u2c0 = torch.round(flow[:, 2]).to(torch.int64)
    u1p0 = torch.round(flow[:, 4]).to(torch.int64)
    vp0 = torch.round(flow[:, 5]).to(torch.int64)
    u2p0 = torch.round(flow[:, 6]).to(torch.int64)

    def windows(img, x0, y0):
        gx, gy = _gradients(img)
        return _Windows(img, gx, gy, torch.clamp(x0 - A, 0, w - _LK_WIN),
                        torch.clamp(y0 - A, 0, h - _LK_WIN))

    def patch(win, x, y, s):
        xs = x[:, None] + off_dx[None, :] * (1.0 + s)[:, None]
        ys = y[:, None] + off_dy[None, :] * (1.0 + s)[:, None]
        return win.sample(xs, ys)

    ui_f, vi_f = ui.to(torch.float32), vi.to(torch.float32)
    ref, _, _ = patch(windows(cur_l, ui, vi), ui_f, vi_f,
                      torch.zeros_like(ui_f))

    def lk(win, x0, y0, solve_y: bool):
        x, y, s = x0, y0, torch.zeros_like(x0)
        for _ in range(iters):
            t, gx, gy = patch(win, x, y, s)
            gs = gx * off_dx[None, :] + gy * off_dy[None, :]
            r = t - ref
            if solve_y:
                g = torch.stack([gx, gy, gs], 1)  # (K, 3, P)
                A3 = torch.einsum("kip,kjp->kij", g, g) \
                    + 1e-4 * torch.eye(3, device=dev)
                bvec = torch.einsum("kip,kp->ki", g, r)
                # solve_ex: no error check, so no host sync
                delta = -torch.linalg.solve_ex(A3, bvec[..., None])[0][..., 0]
                dx, dy, ds = delta[:, 0], delta[:, 1], delta[:, 2]
            else:
                dx = -(gx * r).sum(-1) / ((gx * gx).sum(-1) + 1e-6)
                dy = torch.zeros_like(dx)
                ds = torch.zeros_like(dx)
            x = x + torch.clamp(dx, -1.0, 1.0)
            y = y + torch.clamp(dy, -1.0, 1.0)
            s = torch.clamp(s + torch.clamp(ds, -0.1, 0.1), -0.3, 0.3)
        return (torch.clamp(x, x0 - 1.5, x0 + 1.5),
                torch.clamp(y, y0 - 1.5, y0 + 1.5))

    u2c, _ = lk(windows(cur_r, u2c0, vi), u2c0.to(torch.float32), vi_f,
                False)
    vp0_f = vp0.to(torch.float32)
    u1p, v1p = lk(windows(prev_l, u1p0, vp0), u1p0.to(torch.float32), vp0_f,
                  True)

    # prev-right: x free, row fixed to the refined prev-left row
    win = windows(prev_r, u2p0, vp0)
    x0 = u2p0.to(torch.float32)
    x = x0
    zero = torch.zeros_like(x0)
    for _ in range(iters):
        t, gx, _ = patch(win, x, v1p, zero)
        r = t - ref
        dx = -(gx * r).sum(-1) / ((gx * gx).sum(-1) + 1e-6)
        x = x + torch.clamp(dx, -1.0, 1.0)
    u2p = torch.clamp(x, x0 - 1.5, x0 + 1.5)
    return torch.stack([ui_f, vi_f, u2c, vi_f, u1p, v1p, u2p, v1p], -1)
