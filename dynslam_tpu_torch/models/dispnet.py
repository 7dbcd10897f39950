"""DispNet-lite: a learned stereo-disparity network, the ``nn.Module``
counterpart of ``dynslam_tpu/models/dispnet.py`` (the in-framework
replacement of the reference's offline Caffe DispNet dumps).

Concatenated left and right images -> a strided encoder (two 3x3 convs a
level) -> a decoder with skips -> bilinear upsampling to the frame ->
conv 16 -> conv 1 -> ``sigmoid * max_disparity``, in float32 unless
``dtype`` says otherwise (the sigmoid always in float32). Images are NCHW
in [0, 255]; the disparity is (B, H, W). The convolutions are
``F.conv2d`` (cuDNN on the card), as the JAX package leaves them to XLA.

Training is PyTorch's: ``make_train_step(model, optimizer)`` with
``torch.optim.Adam`` as ``optax.adam``'s counterpart updates the module
in place; ``parallel/sharding.py`` shards it over ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch import nn

from dynslam_tpu_torch.models.layers import (
    INV_255, SameConv2d, encoder_decoder, encoder_decoder_convs, init_flax,
)


class DispNetLite(nn.Module):
    def __init__(self, features: Sequence[int] = (32, 64, 96, 128),
                 max_disparity: float = 96.0,
                 dtype: torch.dtype = torch.float32, channels: int = 3):
        super().__init__()
        self.features = tuple(features)
        self.max_disparity = max_disparity
        self.dtype = dtype
        convs, c = encoder_decoder_convs(2 * channels, self.features)
        self.convs = nn.ModuleList(convs + [SameConv2d(c, 16),
                                            SameConv2d(16, 1)])

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """left/right (B, C, H, W) in [0, 255] -> (B, H, W) disparity."""
        x = torch.cat([left, right], 1).to(self.dtype) * INV_255
        x = encoder_decoder(self.convs, self.features, x)
        x = torch.relu(self.convs[-2](x))
        disp = self.convs[-1](x)
        return torch.sigmoid(disp[:, 0].float()) * self.max_disparity


def create_model(max_disparity: float = 96.0,
                 dtype: torch.dtype = torch.float32) -> DispNetLite:
    return DispNetLite(max_disparity=max_disparity, dtype=dtype)


def init_params(model: DispNetLite, generator: torch.Generator
                ) -> DispNetLite:
    """Flax's initialisers from ``generator``, in place. (Flax traces a
    frame size to infer shapes; a module's shapes are fixed by its
    constructor.)"""
    return init_flax(model, generator)


def disparity_loss_terms(model: nn.Module, left, right, gt_disp, valid_mask):
    """The masked L1's numerator and its mask count, both 0-d."""
    pred = model(left, right)
    m = valid_mask.to(torch.float32)
    return ((pred - gt_disp).abs() * m).sum(), m.sum()


def disparity_loss(model: nn.Module, left, right, gt_disp,
                   valid_mask) -> torch.Tensor:
    """Masked L1 over the batch (the standard disparity regression loss)."""
    err, n = disparity_loss_terms(model, left, right, gt_disp, valid_mask)
    return err / torch.clamp(n, min=1.0)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """``step(batch) -> loss``: one optimiser step on ``batch`` (left,
    right (B, C, H, W), disparity (B, H, W), valid (B, H, W) bool),
    updating ``model`` and ``optimizer`` in place."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = disparity_loss(model, batch["left"], batch["right"],
                              batch["disparity"], batch["valid"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
