"""``seg_worker_ms``: host time a frame of the worker's job: the MNC dump parse, ``select_detections``, ``pack_mask_bits`` and the upload (the harness's own clock around the job, on the worker thread, for the traced frames)."""

LAYER = "segmentation feed"
UNIT = "ms"
MOVES = "frame_device_ms"


def read(s):
    return s.extra.get("seg_worker_ms")
