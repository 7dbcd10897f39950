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
- ``dtype``: the convolutions and resizes compute in it (parameters stay
  float32 and are cast per call, as Flax's ``dtype``/``param_dtype`` do).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

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


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` where it upsamples: half-pixel
    centres, edge samples clamped (JAX renormalises the in-bounds
    weights, which gives the same values)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


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
