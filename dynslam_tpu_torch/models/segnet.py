"""SegNet-lite: a learned car-mask model, the ``nn.Module`` counterpart of
``dynslam_tpu/models/segnet.py`` (the in-framework replacement of the
reference's offline Caffe-MNC dumps), and ``LearnedSegmentationProvider``,
which turns its car probabilities into the ``InstanceDetection``s the
tracker consumes.

The network is DispNet-lite's body over one RGB image (NCHW in [0, 255])
with a conv 8 -> conv 1 head: car logits (B, H, W) in float32.
``save_params``/``load_params`` read and write Flax's msgpack bytes
(``utils/msgpack.py``), so params files move between the two packages.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from dynslam_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from dynslam_tpu_torch.io.images import connected_components
from dynslam_tpu_torch.io.segmentation import (
    BoundingBox, InstanceDetection, InstanceSegmentationResult,
    SegmentationProvider, build_masks,
)
from dynslam_tpu_torch.models.layers import (
    INV_255, SameConv2d, encoder_decoder, encoder_decoder_convs, init_flax,
)
from dynslam_tpu_torch.utils import msgpack

#: VOC class id of "car"
CAR_CLASS_ID = 7


class SegNetLite(nn.Module):
    def __init__(self, features: Sequence[int] = (24, 48, 96),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        convs, c = encoder_decoder_convs(3, self.features)
        self.convs = nn.ModuleList(convs + [SameConv2d(c, 8),
                                            SameConv2d(8, 1)])

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        """rgb (B, 3, H, W) in [0, 255] -> car logits (B, H, W)."""
        x = encoder_decoder(self.convs, self.features,
                            rgb.to(self.dtype) * INV_255)
        x = torch.relu(self.convs[-2](x))
        return self.convs[-1](x)[:, 0].float()


def create_model() -> SegNetLite:
    return SegNetLite()


def init_params(model: SegNetLite, generator: torch.Generator) -> SegNetLite:
    """Flax's initialisers from ``generator``, in place."""
    return init_flax(model, generator)


def save_params(path: str, model: nn.Module) -> None:
    """The module's weights as Flax's msgpack bytes (what the JAX
    package's ``segnet.save_params`` writes for the same weights)."""
    with open(path, "wb") as f:
        f.write(msgpack.to_bytes(state_dict_to_flax(model.state_dict())))


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load a params file written by either package's ``save_params`` into
    ``model`` (shapes must match), in place; returns ``model``."""
    with open(path, "rb") as f:
        state = flax_to_state_dict(msgpack.from_bytes(f.read()))
    own = model.state_dict()
    if set(state) != set(own) or any(
            state[k].shape != own[k].shape for k in own):
        raise ValueError(f"{path!r}: params do not fit {type(model).__name__}")
    model.load_state_dict(state)
    return model


def seg_loss(model: nn.Module, rgb, gt_mask) -> torch.Tensor:
    """Balanced sigmoid cross-entropy (car pixels are rare)."""
    logits = model(rgb)
    gt = gt_mask.to(torch.float32)
    ce = torch.clamp(logits, min=0) - logits * gt + torch.log1p(
        torch.exp(-logits.abs()))
    pos = gt.sum() + 1.0
    neg = (1.0 - gt).sum() + 1.0
    w = torch.where(gt > 0, neg / (pos + neg), pos / (pos + neg))
    return (ce * w).sum() / w.sum()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """``step(batch) -> loss`` on ``batch`` (rgb (B, 3, H, W), mask (B, H,
    W)), updating ``model`` and ``optimizer`` in place."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = seg_loss(model, batch["rgb"], batch["mask"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class LearnedSegmentationProvider(SegmentationProvider):
    """Live segmentation with SegNet-lite on the model's device, emitting
    reference-compatible ``InstanceDetection``s (car, VOC id 7)."""

    def __init__(self, model: SegNetLite, threshold: float = 0.5,
                 min_detection_size_px: int = 45):
        self.model = model
        self.threshold = threshold
        self.min_area = min_detection_size_px ** 2
        self._last_prob = None

    def probabilities(self, rgb: np.ndarray) -> np.ndarray:
        """The model's car probability of each pixel of (H, W, 3) ``rgb``."""
        dev = next(self.model.parameters()).device
        x = torch.from_numpy(np.ascontiguousarray(rgb, np.float32))
        with torch.inference_mode():
            logits = self.model(x.to(dev).permute(2, 0, 1)[None])
            return torch.sigmoid(logits)[0].cpu().numpy()

    def raw_detections(self, rgb: np.ndarray) -> List[tuple]:
        """Connected components of the thresholded probabilities as raw
        (bbox, score, class id, bbox-sized binary mask) tuples: the MNC
        dump's payload (preprocess-sequence.sh:230-257). Components whose
        bbox area is at most ``min_area`` are dropped."""
        prob = self.probabilities(rgb)
        self._last_prob = prob
        n, labels, stats = connected_components(prob > self.threshold)
        out = []
        for i in range(1, n):
            x, y, w, h, _ = (int(v) for v in stats[i])
            if w * h <= self.min_area:
                continue
            bbox = BoundingBox(x, y, x + w - 1, y + h - 1)
            mask = (labels[y:y + h, x:x + w] == i).astype(np.uint8)
            score = float(prob[y:y + h, x:x + w][mask > 0].mean())
            out.append((bbox, score, CAR_CLASS_ID, mask))
        return out

    def segment_frame(self, rgb: np.ndarray) -> InstanceSegmentationResult:
        t0 = time.perf_counter_ns()
        detections: List[InstanceDetection] = []
        for bbox, score, class_id, mask in self.raw_detections(rgb):
            cm, dm, km = build_masks(bbox, mask, self.min_area)
            detections.append(InstanceDetection(score, class_id, cm, dm, km))
        return InstanceSegmentationResult(
            instance_detections=detections,
            inference_time_ns=time.perf_counter_ns() - t0)

    def get_seg_preview(self):
        if self._last_prob is None:
            return None
        g = (self._last_prob * 255).astype(np.uint8)
        return np.stack([g, g, g], -1)
