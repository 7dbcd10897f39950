"""Image and matrix files without OpenCV: the reads and writes the staged
path does through ``cv2`` in the JAX package (the machine with the card
has no ``cv2``).

- ``read_png``: ``cv2.imread(path, IMREAD_COLOR)`` as RGB, for
  non-interlaced 8-bit gray, RGB and RGBA files (gray is expanded to
  three channels and alpha dropped, as OpenCV does); any other PNG raises.
  All five row filters are undone (``_unfilter``).
- ``png_size``: (width, height) from the IHDR chunk alone.
- ``write_png``: 8-bit gray or RGB, the bytes ``cv2.imwrite`` writes
  (libpng's Sub filter, zlib level 1 run-length, 8 KiB IDAT chunks).
- ``read_opencv_xml`` / ``write_opencv_xml``: OpenCV's XML
  ``FileStorage`` holding one ``opencv-matrix`` node (the ELAS depth
  dumps); the reader takes the first matrix node, as
  ``dynslam_tpu/io/depth_providers.py`` does.
- ``resize_nearest``: ``cv2.resize(..., interpolation=INTER_NEAREST)``:
  source index ``min(floor(x / scale), src - 1)`` in double precision,
  OpenCV's ``resizeNN`` rule.
- ``connected_components``: ``cv2.connectedComponentsWithStats`` at
  8-connectivity, label for label (``scipy.ndimage.label``, relabelled in
  OpenCV's 2x2-block scan order).

``tests/test_torch_images.py`` (``test_torch_segnet.py`` for the
components) holds each to ``cv2`` byte for byte.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels, for the 8-bit types read here
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk of a PNG file's bytes."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG file, read from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path!r}")
    return struct.unpack(">II", head[16:24])


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters: ``raw`` (H, W, bpp) filtered bytes,
    ``ftype`` (H,) each row's filter. Rows of None, Sub and Up alone are
    undone row by row; otherwise the image is swept along its pixel
    anti-diagonals, where a pixel's left, upper and upper-left neighbours
    are all decoded one or two steps before it."""
    h, w, bpp = raw.shape
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    if ftype.max(initial=0) <= 2:
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            row = raw[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint64).astype(np.uint8)
            elif ftype[r] == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    f = raw.astype(np.int32)
    ft = ftype.astype(np.int32)
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        x = t - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        k = ft[r][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG as (H, W, 3) uint8 RGB: ``cv2.imread(path)`` with the
    channels in RGB order."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if ihdr is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {path!r}")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path!r}: PNG of bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; only non-interlaced 8-bit gray, RGB and "
            "RGBA are read")
    bpp = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * bpp):
        raise ValueError(f"{path!r}: truncated PNG data")
    rows = rows.reshape(h, 1 + w * bpp)
    img = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


#: libpng's IDAT chunk size (its zlib buffer)
_IDAT_BYTES = 8192


def _zlib_window_bits(n: int) -> int:
    """libpng's ``png_deflate_claim``: the deflate window shrinks to the
    data where the data is at most 16 KiB."""
    bits, half = 15, 1 << 14
    if n <= 16384:
        while n + 262 <= half:
            half >>= 1
            bits -= 1
    return bits


def _optimize_cmf(z: bytes, n: int) -> bytes:
    """libpng's ``optimize_cmf``: the zlib header of a stream of at most
    16 KiB of data declares the smallest window that holds it."""
    cmf = z[0]
    if n > 16384 or (cmf & 0x0f) != 8 or (cmf & 0xf0) > 0x70:
        return z
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if n > half:
        return z
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and n <= half):
            break
    cmf = (cmf & 0x0f) | (cinfo << 4)
    flg = z[1] & 0xe0
    flg += 0x1f - ((cmf << 8) + flg) % 0x1f
    return bytes([cmf, flg]) + z[2:]


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) gray or (H, W, 3) RGB uint8 as an 8-bit PNG, byte for
    byte as ``cv2.imwrite`` writes it (with the channels in BGR order):
    every row Sub-filtered (None where the image is one pixel wide, as
    libpng drops Sub there), zlib level 1 with the run-length strategy,
    libpng's window size and header, IDAT chunks of 8192 bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png: (H, W) or (H, W, 3) uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    flat = img.reshape(h, -1)
    sub = flat.copy()
    sub[:, bpp:] -= flat[:, :-bpp]  # Sub: minus the byte a pixel left
    rows = np.concatenate([np.full((h, 1), 1 if w > 1 else 0, np.uint8),
                           sub], axis=1).tobytes()
    c = zlib.compressobj(1, zlib.DEFLATED, _zlib_window_bits(len(rows)), 8,
                         zlib.Z_RLE)
    z = _optimize_cmf(c.compress(rows) + c.flush(), len(rows))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2,
                       0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr) + b"".join(
            _chunk(b"IDAT", z[i:i + _IDAT_BYTES])
            for i in range(0, len(z), _IDAT_BYTES)) + _chunk(b"IEND", b""))


#: OpenCV's FileStorage depth letters (``ucwsifdh``)
_XML_DTYPES = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
               "i": np.int32, "f": np.float32, "d": np.float64,
               "h": np.float16}


def _is_matrix(node) -> bool:
    return node.get("type_id") == "opencv-matrix" or all(
        node.find(k) is not None for k in ("rows", "cols", "dt", "data"))


def read_opencv_xml(path: str) -> np.ndarray:
    """The first ``opencv-matrix`` node of an OpenCV XML ``FileStorage``
    file as a 2-D array of its stored type."""
    root = ET.parse(path).getroot()
    node = next((n for n in root if _is_matrix(n)), None)
    if node is None:
        raise ValueError(f"no matrix found in XML file {path!r}")
    rows, cols = int(node.findtext("rows")), int(node.findtext("cols"))
    dt = node.findtext("dt").strip()
    if dt not in _XML_DTYPES:
        raise ValueError(f"{path!r}: matrix element type {dt!r}; one-channel "
                         f"{sorted(_XML_DTYPES)} are read")
    dtype = _XML_DTYPES[dt]
    text = node.findtext("data") or ""
    parse = float if np.dtype(dtype).kind == "f" else int
    data = np.array([parse(v) for v in text.split()], dtype=dtype)
    if data.size != rows * cols:
        raise ValueError(f"{path!r}: {data.size} values for a {rows}x{cols} "
                         "matrix")
    return data.reshape(rows, cols)


#: OpenCV's XML emitter starts a new line where a value would end past
#: this column (``wrap_margin``)
_XML_WRAP = 71


def write_opencv_xml(path: str, name: str, matrix: np.ndarray) -> None:
    """Write a 2-D int16 array as OpenCV's ``FileStorage`` writes one
    matrix node (``fs.write(name, matrix)``), byte for byte: values on
    lines indented by 4, a line broken before a value that would end past
    column 71."""
    m = np.asarray(matrix)
    if m.ndim != 2 or m.dtype != np.int16:
        raise ValueError(f"write_opencv_xml: a 2-D int16 matrix, not "
                         f"{m.shape} {m.dtype}")
    lines, line = [], ""
    for v in map(str, m.reshape(-1).tolist()):
        if line and 4 + len(line) + len(v) > _XML_WRAP:
            lines.append(line)
            line = v
        else:
            line = f"{line} {v}" if line else v
    lines.append(line)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<opencv_storage>\n'
                f'<{name} type_id="opencv-matrix">\n'
                f"  <rows>{m.shape[0]}</rows>\n  <cols>{m.shape[1]}</cols>\n"
                "  <dt>s</dt>\n  <data>\n    " + "\n    ".join(lines)
                + f"</data></{name}>\n</opencv_storage>\n")


def connected_components(binary: np.ndarray):
    """``cv2.connectedComponentsWithStats(binary)`` (8-connectivity):
    (n labels with the background's, int32 labels, int32 stats rows (x,
    y, w, h, area)). OpenCV scans in 2x2 blocks (all foreground pixels of
    one block are 8-connected), so labels follow the raster order of each
    component's first block, not of its first pixel."""
    from scipy import ndimage

    fg = np.asarray(binary) != 0
    h, w = fg.shape
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    rows, cols = np.nonzero(fg)
    ids = lab[rows, cols]
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, ids, (rows // 2) * ((w + 1) // 2) + cols // 2)
    remap = np.zeros(n + 1, np.int32)
    remap[np.argsort(first[1:], kind="stable") + 1] = np.arange(
        1, n + 1, dtype=np.int32)
    labels = remap[lab]
    ids = labels[rows, cols]
    stats = np.zeros((n + 1, 5), np.int32)
    x0 = np.full(n + 1, w)
    y0 = np.full(n + 1, h)
    x1 = np.full(n + 1, -1)
    y1 = np.full(n + 1, -1)
    np.minimum.at(x0, ids, cols)
    np.minimum.at(y0, ids, rows)
    np.maximum.at(x1, ids, cols)
    np.maximum.at(y1, ids, rows)
    area = np.bincount(ids, minlength=n + 1)
    stats[1:] = np.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1, area], 1)[1:]
    # the background's row, as OpenCV fills it: the bbox of the zeros, or
    # (-1, INT_MAX, 0, 0, 0) where there are none
    bg_rows, bg_cols = np.nonzero(~fg)
    stats[0] = (bg_cols.min(), bg_rows.min(),
                bg_cols.max() - bg_cols.min() + 1,
                bg_rows.max() - bg_rows.min() + 1, bg_rows.size) \
        if bg_rows.size else (-1, np.iinfo(np.int32).max, 0, 0, 0)
    return n + 1, labels, stats


def resize_nearest(src: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
                   fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(src, dsize, fx=fx, fy=fy,
    interpolation=cv2.INTER_NEAREST)``: ``dsize`` (width, height), or
    None to scale by (fx, fy) and round the size to the nearest integer.
    Destination index d takes source index min(floor(d / scale), n - 1),
    in double precision."""
    src = np.asarray(src)
    h, w = src.shape[:2]
    if dsize is None:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize_nearest: dsize or positive fx, fy")
        dw, dh = int(round(w * fx)), int(round(h * fy))
    else:
        dw, dh = dsize
        fx, fy = dw / w, dh / h
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_nearest: empty destination {dw}x{dh}")
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / fx)).astype(np.int64),
                    w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / fy)).astype(np.int64),
                    h - 1)
    return np.ascontiguousarray(src[ys[:, None], xs[None, :]])
