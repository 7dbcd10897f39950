"""The segmentation feed in numpy: a frozen copy of the port's
``io/segmentation.py`` mask rules (``BoundingBox``, ``Mask``, OpenCV's
bilinear resize written out, ``build_masks``), an MNC dump reader of its
own, and the selection and bit-plane packing of
``FusedDynamicPipeline.select_detections`` / ``pack_mask_bits``."""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np

PASCAL_VOC_2012_CLASSES = [
    "INVALID",  # VOC 2012 class IDs are 1-based
    "airplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
VOC_LABEL_TO_ID = {name: i for i, name in enumerate(PASCAL_VOC_2012_CLASSES)}

#: classes reconstructed in volumes of their own
#: (InstanceReconstructor.cpp:25)
CLASSES_TO_RECONSTRUCT = ("car", "bus")
#: classes cut out of the static map even when not reconstructed
#: (InstanceReconstructor.cpp:27-42)
POSSIBLY_DYNAMIC_CLASSES = (
    "airplane", "bicycle", "bird", "boat", "bus", "car", "cat", "cow",
    "dog", "horse", "motorbike", "person", "sheep", "train",
)

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


@dataclass
class BoundingBox:
    """Inclusive-coordinate bbox (x0, y0)..(x1, y1). Ref: BoundingBox.h."""

    x0: int
    y0: int
    x1: int
    y1: int

    @property
    def width(self) -> int:
        return self.x1 - self.x0 + 1

    @property
    def height(self) -> int:
        return self.y1 - self.y0 + 1

    @property
    def area(self) -> int:
        return max(self.width, 0) * max(self.height, 0)

    def intersect(self, other: "BoundingBox") -> Optional["BoundingBox"]:
        """Ref: BoundingBox::IntersectWith (BoundingBox.cpp:15-29)."""
        x0 = max(self.x0, other.x0)
        y0 = max(self.y0, other.y0)
        x1 = min(self.x1, other.x1)
        y1 = min(self.y1, other.y1)
        if x0 > x1 or y0 > y1:
            return None
        return BoundingBox(x0, y0, x1, y1)

    def iou(self, other: "BoundingBox") -> float:
        inter = self.intersect(other)
        if inter is None:
            return 0.0
        ia = inter.area
        return ia / float(self.area + other.area - ia)


def _taps(src: int, dst: int):
    """Source index and fixed-point weight pair of each destination index
    (OpenCV's ``resizeGeneric_`` table): the source position
    ``(d + 0.5) * scale - 0.5`` in float32, split into its floor and
    fraction, each weight rounded to an 11-bit fixed point on its own."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return s, w0.astype(np.int64), w1.astype(np.int64)


def _resize_linear_u8(data: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """``cv2.resize(data, (new_w, new_h), interpolation=INTER_LINEAR)`` of
    a 2-D uint8 array."""
    h, w = data.shape
    if (new_h, new_w) == (h, w):
        return data.copy()
    src = data.astype(np.int64)
    # horizontal: taps left of 0 or right of w - 1 clamp to the edge pixel
    # with the whole weight
    sx, a0, a1 = _taps(w, new_w)
    edge = (sx < 0) | (sx >= w - 1)
    sx = np.clip(sx, 0, w - 1)
    a0 = np.where(edge, _COEF_SCALE, a0)
    a1 = np.where(edge, 0, a1)
    rows = src[:, sx] * a0 + src[:, np.minimum(sx + 1, w - 1)] * a1
    # vertical: the fraction is kept and the two source rows clamp
    sy, b0, b1 = _taps(h, new_h)
    r0 = rows[np.clip(sy, 0, h - 1)]
    r1 = rows[np.clip(sy + 1, 0, h - 1)]
    out = (((b0[:, None] * (r0 >> 4)) >> 16)
           + ((b1[:, None] * (r1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


class Mask:
    """Binary mask over a bbox region. Ref: Utils/Mask.{h,cpp}."""

    def __init__(self, bbox: BoundingBox, data: np.ndarray):
        assert data.shape == (bbox.height, bbox.width), (
            f"mask shape {data.shape} != bbox {bbox.height}x{bbox.width}"
        )
        self.bbox = bbox
        self.data = np.asarray(data, dtype=np.uint8)

    def copy(self) -> "Mask":
        return Mask(BoundingBox(*vars(self.bbox).values()), self.data.copy())

    def rescale(self, amount: float) -> None:
        """Resize about the bbox center. Ref: Mask::Rescale (Mask.cpp:19-44)."""
        old_w, old_h = self.bbox.width, self.bbox.height
        new_w = int(old_w * amount)
        new_h = int(old_h * amount)
        dw, dh = new_w - old_w, new_h - old_h
        new_x0 = self.bbox.x0 - int(math.floor(dw / 2.0))
        new_y0 = self.bbox.y0 - int(math.floor(dh / 2.0))
        new_x1 = self.bbox.x1 + int(math.ceil(dw / 2.0))
        new_y1 = self.bbox.y1 + int(math.ceil(dh / 2.0))
        self.data = _resize_linear_u8(self.data, new_w, new_h)
        self.bbox = BoundingBox(new_x0, new_y0, new_x1, new_y1)
        assert self.bbox.width == new_w and self.bbox.height == new_h

    def to_full_frame(self, height: int, width: int) -> np.ndarray:
        """Rasterize into a full-frame bool array."""
        out = np.zeros((height, width), dtype=bool)
        bx0, by0 = max(self.bbox.x0, 0), max(self.bbox.y0, 0)
        bx1, by1 = min(self.bbox.x1, width - 1), min(self.bbox.y1, height - 1)
        if bx0 > bx1 or by0 > by1:
            return out
        sub = self.data[
            by0 - self.bbox.y0: by1 - self.bbox.y0 + 1,
            bx0 - self.bbox.x0: bx1 - self.bbox.x0 + 1,
        ]
        out[by0: by1 + 1, bx0: bx1 + 1] = sub > 0
        return out


def build_masks(
    bbox: BoundingBox,
    mask_data: np.ndarray,
    min_area: int,
    copy_scale: float = 1.0,
    delete_scale: float = 1.2,
    conservative_scale: float = 0.97,
) -> tuple:
    """The reference's 3-mask construction incl. the extra x1.2 delete-mask
    growth for small bboxes (PrecomputedSegmentationProvider.cpp:133-150)."""
    copy_mask = Mask(bbox, mask_data)
    delete_mask = copy_mask.copy()
    conservative_mask = copy_mask.copy()
    copy_mask.rescale(copy_scale)
    del_scale = delete_scale
    if bbox.area < min_area * 1.375:
        del_scale *= 1.2
    delete_mask.rescale(del_scale)
    conservative_mask.rescale(conservative_scale)
    return copy_mask, delete_mask, conservative_mask



class Detection(NamedTuple):
    class_id: int
    copy_mask: Mask
    delete_mask: Mask

    def is_possibly_dynamic(self) -> bool:
        return PASCAL_VOC_2012_CLASSES[self.class_id] \
            in POSSIBLY_DYNAMIC_CLASSES

    def is_reconstructable(self) -> bool:
        return PASCAL_VOC_2012_CLASSES[self.class_id] \
            in CLASSES_TO_RECONSTRUCT


def read_detections(seg_folder: str, frame: int,
                    min_detection_size_px: int) -> List[Detection]:
    """Frame ``frame``'s MNC dump (``<frame>.png.<i>.result.txt`` with its
    ``.mask.txt``, i = 0, 1, ... until one is missing): the detections
    whose bbox is larger than the minimum size squared, with their copy
    and delete masks, at full resolution."""
    min_area = int(round(min_detection_size_px ** 2))
    base = os.path.join(seg_folder, f"{frame:06d}.png")
    dets = []
    i = 0
    while True:
        result = f"{base}.{i:04d}.result.txt"
        mask = f"{base}.{i:04d}.mask.txt"
        if not (os.path.exists(result) and os.path.exists(mask)):
            return dets
        with open(result) as f:
            head, rest = f.readline().strip().split("]", 1)
        x0, y0, x1, y1 = (int(float(v)) for v in head.strip("[").split()[:4])
        class_id = int(rest.strip(", ").split(",")[1])
        bbox = BoundingBox(x0, y0, x1, y1)
        if bbox.area > min_area:
            data = np.loadtxt(mask, dtype=np.float64, ndmin=2)
            if data.shape != (bbox.height, bbox.width):
                raise ValueError(f"{mask}: shape {data.shape}, bbox "
                                 f"{bbox.height}x{bbox.width}")
            cm, dm, _ = build_masks(bbox, data.astype(np.uint8), min_area)
            dets.append(Detection(class_id, cm, dm))
        i += 1


def select(dets: List[Detection], k: int) -> List[Detection]:
    """The possibly-dynamic detections, the ``k`` largest by copy-mask bbox
    area when there are more (ties keep dump order)."""
    cands = [d for d in dets if d.is_possibly_dynamic()]
    if len(cands) > k:
        cands = sorted(cands, key=lambda d: d.copy_mask.bbox.area,
                       reverse=True)[:k]
    return cands


def pack_bits(dets: List[Detection], h: int, w: int):
    """(delete, copy) planes of the selected detections as int64: bit j is
    slot j's delete mask, and its copy mask where the class is
    reconstructed."""
    delete = np.zeros((h, w), np.int64)
    copy = np.zeros((h, w), np.int64)
    for j, d in enumerate(dets):
        delete |= d.delete_mask.to_full_frame(h, w).astype(np.int64) << j
        if d.is_reconstructable():
            copy |= d.copy_mask.to_full_frame(h, w).astype(np.int64) << j
    return delete, copy
