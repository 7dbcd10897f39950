"""Portable Float Map (PFM) IO — a copy of ``dynslam_tpu/utils/pfm.py``
(the reference's `src/pfmLib` `ReadFilePFM` / `WriteFilePFM`, used at
PrecomputedDepthProvider.cpp:31) in NumPy.

PFM stores float32 images bottom-up; the scale line's sign encodes
endianness (negative = little-endian).
"""

from __future__ import annotations

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file into a float32 array (H, W) or (H, W, 3), top-down."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path!r} (header {header!r})")

        dims = b""
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"truncated PFM header: {path!r}")
            if line.strip().startswith(b"#"):
                continue
            dims += b" " + line.strip()
            parts = dims.split()
            if len(parts) >= 2:
                width, height = int(parts[0]), int(parts[1])
                break

        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        count = width * height * channels
        data = np.frombuffer(f.read(count * 4), dtype=endian + "f4", count=count)

    shape = (height, width, 3) if channels == 3 else (height, width)
    img = data.reshape(shape)
    # PFM rows are stored bottom-up
    return np.ascontiguousarray(np.flipud(img)).astype(np.float32)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array (H, W) or (H, W, 3) as little-endian PFM."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        header = b"Pf"
    elif image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"unsupported PFM shape: {image.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # negative = little endian
        np.flipud(image).astype("<f4").tofile(f)
