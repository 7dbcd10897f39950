"""Native (C++) readers for the staged path's files: MNC text masks, PFM
disparities, velodyne scans and PNG row filters (``fastio.cpp``, a plain
C library loaded with ``ctypes``; ``fastio.py`` wraps it). A ``ctypes``
call releases the interpreter lock, so a reader thread parses while the
frame thread runs Python.

The readers (``io/segmentation.py``, ``utils/pfm.py``,
``io/velodyne.py``, ``io/images.py``) take the native parsers unless the
environment sets ``DYNSLAM_NO_NATIVE_BUILD`` (the JAX package's switch),
which selects their numpy twins. Otherwise the library is built with g++
at first use, and a failed build or load raises: there is no quiet
fallback to numpy.
"""

from __future__ import annotations

import os

#: set (non-empty) to read with the numpy twins and build nothing
SWITCH = "DYNSLAM_NO_NATIVE_BUILD"


def mode() -> str:
    """Which parsers the readers take now: ``"native"`` or ``"numpy"``."""
    return "numpy" if os.environ.get(SWITCH) else "native"


def available() -> bool:
    """Whether this process has loaded the native library (a native read
    ran, or ``fastio.library()`` was called)."""
    from dynslam_tpu_torch.native import fastio

    return fastio.library.cache_info().currsize > 0
