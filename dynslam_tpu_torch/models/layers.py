"""What DispNet-lite and SegNet-lite share: Flax's ``nn.Conv`` with
``SAME`` padding, Flax's initialiser, ``jax.image.resize``'s bilinear
upsampling, and the strided encoder / decoder-with-skips body both
models run (``dynslam_tpu/models/dispnet.py:35-52``, ``segnet.py:41-56``).

Layout: NCHW (Flax's NHWC with the channel axis moved to 1; concatenations
keep their channel order). A module's convolutions sit in ``convs`` in
the order Flax creates them, so ``convs.<i>`` is Flax's ``Conv_<i>``
(``convert.py``).

- ``SAME`` padding at stride 2 is asymmetric where the input size is
  even: XLA pads (0, 1), not (1, 1). ``nn.Conv2d(padding=1)`` would shift
  every strided output by half a pixel, so ``SameConv2d`` pads with
  ``F.pad`` and convolves with ``padding=0``.
- ``jax.image.resize`` is no gather: it contracts the input with one
  weight matrix per resized axis (``resize_bilinear``). So is the port's,
  which makes its backward a matmul too, with no atomics: deterministic on
  the card.
- ``dtype``: the convolutions and resizes compute in it (parameters stay
  float32 and are cast per call, as Flax's ``dtype``/``param_dtype`` do).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynslam_tpu_torch.ops.tsdf import recip32

#: float32 1 / 255, the constant XLA multiplies by for the models' ``/ 255.0``
INV_255 = recip32(255.0)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A 3x3 ``nn.Conv2d`` padded as Flax's ``nn.Conv(padding="SAME")``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__(in_channels, out_channels, 3, stride=stride,
                         padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x, self.weight, self.bias, self.stride[0])


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              stride: int) -> torch.Tensor:
    """``SAME``-padded convolution in ``x``'s dtype."""
    k = weight.shape[-1]
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), stride)


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """``jax._src.image.scale.compute_weight_mat`` for the triangle kernel,
    antialias off: (n_out, n_in) float32. Sample centres are half-pixel,
    ``(o + 0.5) * (n_in / n_out) - 0.5`` with the product and the
    subtraction rounded once, as XLA's CPU code fuses them into one FMA
    (taken in float64, where the product of two float32s is exact); taps
    out of range are dropped and the rest renormalised; an output whose
    sample lies outside ``[-0.5, n_in - 0.5]`` gets no weight."""
    inv = np.float32(1.0 / (n_out / n_in))
    centre = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    sample = (centre.astype(np.float64) * float(inv) - 0.5).astype(np.float32)
    dist = np.abs(sample[None] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - dist)
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None], w, np.float32(0)).T,
                                np.float32)


#: ``_weights``' matrices by (n_in, n_out, dtype, device), as
#: ``device.CONSTANTS`` keeps its constants
WEIGHTS: Dict[tuple, torch.Tensor] = {}


def _weights(n_in: int, n_out: int, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """``_triangle_weights`` on ``device`` in ``dtype``, made once per
    process and shared: callers must not write into it."""
    key = (n_in, n_out, dtype, device)
    w = WEIGHTS.get(key)
    if w is None:
        w = WEIGHTS[key] = torch.tensor(_triangle_weights(n_in, n_out),
                                        dtype=dtype, device=device)
    return w


def width_first(h_in: int, w_in: int, h_out: int, w_out: int) -> bool:
    """Whether ``jnp.einsum`` contracts the width axis first: its path
    takes the order of fewer operations, ``h_in * w_out * (w_in + h_out)``
    against ``w_in * h_out * (h_in + w_out)`` (the batch and channels
    scale both alike)."""
    return h_in * w_out * (w_in + h_out) <= w_in * h_out * (h_in + w_out)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of NCHW ``x`` to ``size`` (H,
    W), antialias off (the models only upsample, where antialiasing does
    nothing): as ``jax._src.image.scale._scale_and_translate``, the input
    contracted with one weight matrix per resized axis (``_weights``), in
    the order ``jnp.einsum`` takes (``width_first``). An axis whose size
    stays is left alone, as JAX skips it."""
    (h_in, w_in), (h_out, w_out) = x.shape[-2:], tuple(size)

    def along_w(t):
        return t if w_in == w_out else \
            t @ _weights(w_in, w_out, t.dtype, t.device).mT

    def along_h(t):
        return t if h_in == h_out else \
            _weights(h_in, h_out, t.dtype, t.device) @ t

    if width_first(h_in, w_in, h_out, w_out):
        return along_h(along_w(x))
    return along_w(along_h(x))


def encoder_decoder_convs(in_channels: int, features: Sequence[int]):
    """The body's convolutions in Flax's order: per encoder level a
    stride-2 and a stride-1 conv, then one conv per decoder level over
    [upsampled, skip]. Returns (convs, channels out)."""
    convs, c = [], in_channels
    for f in features:
        convs += [SameConv2d(c, f, stride=2), SameConv2d(f, f)]
        c = f
    for f in reversed(features[:-1]):  # the skip has f channels too
        convs.append(SameConv2d(c + f, f))
        c = f
    return convs, c


def encoder_decoder(convs, features: Sequence[int],
                    x: torch.Tensor) -> torch.Tensor:
    """Run the body (``encoder_decoder_convs``' layers) and upsample its
    output to ``x``'s size."""
    h, w = x.shape[-2:]
    skips, i = [], 0
    for _ in features:
        x = F.relu(convs[i](x))
        x = F.relu(convs[i + 1](x))
        skips.append(x)
        i += 2
    for skip in reversed(skips[:-1]):
        x = resize_bilinear(x, skip.shape[-2:])
        x = F.relu(convs[i](torch.cat([x, skip], 1)))
        i += 1
    return resize_bilinear(x, (h, w))


def init_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisers: kernels ``lecun_normal`` (a normal
    truncated at two standard deviations, variance 1 / fan_in), biases
    zero. In place; returns ``module``."""
    with torch.no_grad():
        for conv in module.convs:
            fan_in = conv.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            conv.bias.zero_()
    return module
