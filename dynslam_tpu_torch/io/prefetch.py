"""Prefetching input — the port of ``dynslam_tpu/io/prefetch.py``, the
host-side overlap of reading and computing that the reference gets from
``std::async`` (DynSlam.cpp:33-112): while the pipeline works on frame k,
one reader thread decodes frame k+1's stereo pair and depth dump and
warms the page cache for its segmentation dumps.

``PrefetchingInput`` stands in for an ``Input``: ``read_next_frame`` takes
the prefetched frame (``Input.load_frame``) and makes it current
(``Input.set_frame``) on the caller's thread, then schedules the next
read. The frames, and so every output, are those of the plain ``Input``.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from dynslam_tpu_torch.io.input import Input

#: at most this many instance dumps a frame are read ahead
_MAX_DUMPS = 32


class PrefetchingInput:
    def __init__(self, inner: Input, prefetch_seg_folder: Optional[str] = None):
        self._inner = inner
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="dynslam-io")
        self._pending: Optional[Future] = None
        self._seg_folder = prefetch_seg_folder
        self._schedule()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def frame_idx(self) -> int:
        return self._inner.frame_idx

    @frame_idx.setter
    def frame_idx(self, value: int) -> None:
        """Seek (a resumed run): drop the read in flight, read ``value``."""
        if self._pending is not None:
            self._pending.result()
        self._inner.frame_idx = value
        self._schedule()

    def _load(self, frame_idx: int):
        frame = self._inner.load_frame(frame_idx)
        if self._seg_folder:
            base = os.path.join(self._seg_folder, f"{frame_idx:06d}.png")
            k = 0
            while k < _MAX_DUMPS and os.path.exists(
                    f"{base}.{k:04d}.result.txt"):
                with open(f"{base}.{k:04d}.mask.txt", "rb") as f:
                    f.read()
                k += 1
        return frame

    def _schedule(self) -> None:
        inner = self._inner
        self._pending = self._pool.submit(self._load, inner.frame_idx) \
            if inner.has_more_images() else None

    def read_next_frame(self) -> bool:
        if self._pending is None:
            return self._inner.read_next_frame()
        self._inner.set_frame(*self._pending.result())
        self._schedule()
        return True

    def close(self) -> None:
        """Stop the reader thread (after the read in flight)."""
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pending = None
