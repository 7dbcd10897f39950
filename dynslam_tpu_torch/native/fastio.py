"""``ctypes`` wrappers of ``fastio.cpp``: the caller-side half of the C
ABI. Each wrapper checks its arguments, allocates the numpy output,
passes pointers and sizes, and raises what the JAX package's extension
raises (``dynslam_tpu/native/fastio.cpp``): ``FileNotFoundError`` for a
file it cannot open, ``ValueError`` naming the offset, row or shape of a
malformed one."""

from __future__ import annotations

import functools
import os

import numpy as np

from dynslam_tpu_torch.native import build


@functools.cache
def library():
    """The loaded library, built at the first call (raises when the
    build or the load fails)."""
    lib = build.load()
    if lib.fastio_abi_version() != 1:
        raise RuntimeError("fastio: the library's C ABI is not version 1")
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check(rc: int, path, info, what: str, shape=None) -> None:
    if rc == 0:
        return
    if rc == 1:
        raise FileNotFoundError(f"cannot read {what} file {path}")
    if rc == 2:
        raise ValueError(f"bad token in {what} file {path} at offset "
                         f"{int(info[0])}")
    if rc in (3, 4):
        h, w = shape
        got = (f"row {int(info[0])} has {int(info[1])} values"
               if rc == 3 else f"{int(info[0])} rows, {int(info[1])} values")
        raise ValueError(f"{what} file {path}: {got}; expected {h}x{w}="
                         f"{h * w}")
    if rc == 5:
        raise ValueError(f"not a PFM file: {path}")
    if rc == 6:
        raise ValueError(f"truncated PFM header or bad dims: {path}")
    if rc == 7:
        raise ValueError(f"truncated {what} data in {path}")
    if rc == 8:
        raise ValueError(f"PNG: unknown row filter {int(info[1])} (row "
                         f"{int(info[0])})")
    raise RuntimeError(f"fastio: unknown return code {rc}")


def read_text_mask(path: str, height: int, width: int) -> np.ndarray:
    """A numpy-text binary mask file as (height, width) uint8."""
    if height <= 0 or width <= 0:
        raise ValueError(f"mask shape {height}x{width}")
    out = np.zeros((height, width), np.uint8)
    info = np.zeros(2, np.int64)
    rc = library().fastio_read_text_mask(os.fsencode(path), height, width,
                                         _ptr(out), _ptr(info))
    _check(rc, path, info, "mask", (height, width))
    return out


def read_pfm(path: str) -> np.ndarray:
    """A PFM file as float32 (H, W) or (H, W, 3), top-down."""
    lib = library()
    dims = np.zeros(4, np.int64)
    offset = np.zeros(1, np.int64)
    p = os.fsencode(path)
    _check(lib.fastio_pfm_header(p, _ptr(dims), _ptr(offset)), path, None,
           "PFM")
    w, h, c, little = (int(x) for x in dims)
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.float32)
    _check(lib.fastio_read_pfm(p, int(offset[0]), w, h, c, little,
                               _ptr(out)), path, None, "PFM")
    return out


def read_velodyne(path: str) -> np.ndarray:
    """A KITTI velodyne scan as (N, 4) float32."""
    try:
        n = os.stat(path).st_size
    except FileNotFoundError:
        raise FileNotFoundError(f"cannot read velodyne file {path}") from None
    if n % 16:
        raise ValueError(f"corrupt velodyne frame {path}: {n} bytes is not a "
                         "multiple of 16")
    out = np.empty((n // 16, 4), np.float32)
    _check(library().fastio_read_file(os.fsencode(path), _ptr(out), n), path,
           None, "velodyne")
    return out


def png_unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters: ``raw`` (H, W, bpp) uint8 filtered bytes
    (rows may be strided, each row contiguous), ``ftype`` (H,) uint8 each
    row's filter; returns (H, W, bpp) uint8."""
    if raw.dtype != np.uint8 or ftype.dtype != np.uint8 or raw.ndim != 3 \
            or ftype.shape != raw.shape[:1]:
        raise ValueError(f"png_unfilter: (H, W, bpp) and (H,) uint8, not "
                         f"{raw.shape} {raw.dtype}, {ftype.shape} "
                         f"{ftype.dtype}")
    h, w, bpp = raw.shape
    if raw.strides[1:] != (bpp, 1):
        raise ValueError("png_unfilter: each row of raw must be contiguous")
    out = np.empty((h, w, bpp), np.uint8)
    info = np.zeros(2, np.int64)
    rc = library().fastio_png_unfilter(_ptr(raw), raw.strides[0],
                                       _ptr(ftype), ftype.strides[0], h, w,
                                       bpp, _ptr(out), _ptr(info))
    _check(rc, None, info, "PNG")
    return out
