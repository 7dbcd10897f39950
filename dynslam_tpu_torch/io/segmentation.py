"""Instance-segmentation data model — a numpy copy of the parts of
``dynslam_tpu/io/segmentation.py`` the dynamic step reads: ``BoundingBox``,
``Mask``, ``InstanceDetection``, the class lists, ``build_masks`` and
``detections_from_instance_ids``.

``Mask.rescale`` resizes without OpenCV (the machine with the card has no
``cv2``): ``_resize_linear_u8`` is OpenCV's uint8 ``INTER_LINEAR`` rule
written out — half-pixel centres, 11-bit fixed-point tap weights, the
horizontal pass in integers, the vertical pass as
``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >> 2``.
``tests/test_torch_segmentation.py`` holds it to ``cv2.resize`` byte for
byte. ``PrecomputedSegmentationProvider`` reads the MNC dumps (numpy-text
masks; a bbox rescaled to the working resolution takes OpenCV's nearest
resize from ``io/images.py``), and ``write_mnc_dump`` writes them.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from dynslam_tpu_torch.io.images import read_png, resize_nearest, write_png

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


@dataclass
class InstanceDetection:
    """One detection. Ref: InstanceSegmentationResult.h:21-71."""

    class_probability: float
    class_id: int
    copy_mask: Mask
    delete_mask: Mask
    conservative_mask: Mask

    @property
    def class_name(self) -> str:
        return PASCAL_VOC_2012_CLASSES[self.class_id]

    def is_reconstructable(self) -> bool:
        return self.class_name in CLASSES_TO_RECONSTRUCT

    def is_possibly_dynamic(self) -> bool:
        return self.class_name in POSSIBLY_DYNAMIC_CLASSES

    def __repr__(self):
        b = self.copy_mask.bbox
        return (
            f"InstanceDetection({self.class_name}, p={self.class_probability:.2f}, "
            f"bbox=({b.x0},{b.y0})-({b.x1},{b.y1}))"
        )


@dataclass
class InstanceSegmentationResult:
    """One frame's detections (InstanceSegmentationResult.h:74-101)."""

    instance_detections: List[InstanceDetection] = field(default_factory=list)
    inference_time_ns: int = 0


class SegmentationProvider:
    """Segmentation source (SegmentationProvider.h:21)."""

    def segment_frame(self, rgb: np.ndarray) -> InstanceSegmentationResult:
        raise NotImplementedError

    def get_seg_preview(self) -> Optional[np.ndarray]:
        return None


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


def detections_from_instance_ids(
    objid: np.ndarray,
    min_size_px: int = 45,
    score: float = 0.95,
    class_id: int = 7,
) -> List[InstanceDetection]:
    """Ground-truth instance-id image -> InstanceDetection list (the
    segmentation dump's role for synthetic data): ids <= 0 are background,
    each positive id with >= 16 pixels is one detection of VOC class
    ``class_id`` (default 7 = car)."""
    dets = []
    for oid in np.unique(objid):
        if oid <= 0:
            continue
        mask = objid == oid
        if mask.sum() < 16:
            continue
        ys, xs = np.nonzero(mask)
        bbox = BoundingBox(int(xs.min()), int(ys.min()),
                           int(xs.max()), int(ys.max()))
        sub = mask[bbox.y0: bbox.y1 + 1, bbox.x0: bbox.x1 + 1]
        cm, dm, km = build_masks(bbox, sub.astype(np.uint8),
                                 min_size_px ** 2)
        dets.append(InstanceDetection(score, class_id, cm, dm, km))
    return dets


class PrecomputedSegmentationProvider(SegmentationProvider):
    """Reads MNC dumps from disk (PrecomputedSegmentationProvider.
    {h,cpp})."""

    def __init__(self, seg_folder: str, frame_offset: int = 0,
                 input_scale: float = 1.0, min_detection_size_px: int = 45):
        self.seg_folder = seg_folder
        self.frame_idx = frame_offset
        self.input_scale = input_scale
        self.min_detection_size_px = min_detection_size_px
        self._last_preview: Optional[np.ndarray] = None

    @staticmethod
    def _read_mask(path: str, width: int, height: int) -> np.ndarray:
        """A numpy-text binary mask, exactly bbox-sized
        (PrecomputedSegmentationProvider.cpp:37-72)."""
        data = np.loadtxt(path, dtype=np.float64, ndmin=2).astype(np.uint8)
        if data.shape != (height, width):
            raise ValueError(f"mask {path!r} has shape {data.shape}, "
                             f"expected {(height, width)}")
        return data

    def read_instance_info(self, base_img_fpath: str
                           ) -> List[InstanceDetection]:
        """ReadInstanceInfo (PrecomputedSegmentationProvider.cpp:74-159)."""
        min_area = int(round(self.min_detection_size_px ** 2
                             * self.input_scale))
        detections: List[InstanceDetection] = []
        instance_idx = 0
        while True:
            result_path = f"{base_img_fpath}.{instance_idx:04d}.result.txt"
            mask_path = f"{base_img_fpath}.{instance_idx:04d}.mask.txt"
            if not (os.path.exists(result_path)
                    and os.path.exists(mask_path)):
                break
            with open(result_path) as f:
                line = f.readline().strip()
            # format: "[x1 y1 x2 y2 junk], probability, class"
            bracket, rest = line.split("]", 1)
            nums = bracket.strip("[").split()
            x0, y0, x1, y1 = (int(float(v)) for v in nums[:4])
            prob_str, class_str = (p.strip() for p in
                                   rest.strip(", ").split(",")[:2])
            bbox = BoundingBox(x0, y0, x1, y1)
            if bbox.area > min_area:
                mask_data = self._read_mask(mask_path, bbox.width,
                                            bbox.height)
                # the bbox at the working resolution
                sc = self.input_scale
                bbox = BoundingBox(int(round(x0 / sc)), int(round(y0 / sc)),
                                   int(round(x1 / sc)), int(round(y1 / sc)))
                if (bbox.height, bbox.width) != mask_data.shape:
                    mask_data = resize_nearest(mask_data,
                                               (bbox.width, bbox.height))
                cm, dm, km = build_masks(bbox, mask_data, min_area)
                detections.append(InstanceDetection(
                    float(prob_str), int(class_str), cm, dm, km))
            instance_idx += 1
        return detections

    def segment_frame(self, rgb: np.ndarray) -> InstanceSegmentationResult:
        t0 = time.perf_counter_ns()
        base = os.path.join(self.seg_folder, f"{self.frame_idx:06d}.png")
        detections = self.read_instance_info(base)
        preview_path = os.path.join(self.seg_folder,
                                    f"cls_{self.frame_idx:06d}.png")
        if os.path.exists(preview_path):
            self._last_preview = read_png(preview_path)
        self.frame_idx += 1
        return InstanceSegmentationResult(
            instance_detections=detections,
            inference_time_ns=time.perf_counter_ns() - t0)

    def get_seg_preview(self) -> Optional[np.ndarray]:
        return self._last_preview


def write_mnc_dump(seg_folder: str, frame_idx: int, detections: List[tuple],
                   preview: Optional[np.ndarray] = None) -> None:
    """Write detections in the MNC dump format; each detection is (bbox:
    BoundingBox, prob, class_id, mask_data). ``preview`` (H, W, 3) RGB
    goes to ``cls_<frame>.png``."""
    os.makedirs(seg_folder, exist_ok=True)
    base = os.path.join(seg_folder, f"{frame_idx:06d}.png")
    for i, (bbox, prob, class_id, mask_data) in enumerate(detections):
        with open(f"{base}.{i:04d}.result.txt", "w") as f:
            f.write(f"[{bbox.x0} {bbox.y0} {bbox.x1} {bbox.y1} 0], "
                    f"{prob:.6f}, {class_id}\n")
        np.savetxt(f"{base}.{i:04d}.mask.txt",
                   np.asarray(mask_data, dtype=np.uint8), fmt="%d")
    if preview is not None:
        write_png(os.path.join(seg_folder, f"cls_{frame_idx:06d}.png"),
                  np.asarray(preview, np.uint8))
