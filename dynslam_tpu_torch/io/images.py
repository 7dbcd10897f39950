"""Image and matrix files without OpenCV: the reads and writes the staged
path does through ``cv2`` in the JAX package (the machine with the card
has no ``cv2``).

- ``read_png``: ``cv2.imread(path, IMREAD_COLOR)`` as RGB, for
  non-interlaced 8-bit gray, RGB and RGBA files (gray is expanded to
  three channels and alpha dropped, as OpenCV does); any other PNG raises.
  All five row filters are undone, by ``native/fastio.cpp``
  (``fastio.png_unfilter``) or, under ``DYNSLAM_NO_NATIVE_BUILD``, by its
  numpy twin ``_unfilter``.
- ``read_png_gray``: ``cv2.imread(path, IMREAD_GRAYSCALE)``: libpng's
  ``png_set_rgb_to_gray(0.299, 0.587)`` on colour files, which truncates.
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
- ``resize_area``: ``cv2.resize(..., interpolation=INTER_AREA)`` for
  shrinking uint8 images: OpenCV's ``resizeAreaFast`` at integer factors
  (2x2 blocks as ``(sum + 2) >> 2``), its float32 area tables otherwise.
- ``bgr_to_gray``: ``cv2.cvtColor(..., COLOR_BGR2GRAY)`` on uint8,
  OpenCV's 15-bit fixed-point weights.
- ``connected_components``: ``cv2.connectedComponentsWithStats`` at
  8-connectivity, label for label (``scipy.ndimage.label``, relabelled in
  OpenCV's 2x2-block scan order).

``tests/test_torch_images.py`` (``test_torch_segnet.py`` for the
components) holds each to ``cv2`` byte for byte.
"""

from __future__ import annotations

import math
import struct
import xml.etree.ElementTree as ET
import zlib
from typing import Optional, Tuple

import numpy as np

from dynslam_tpu_torch import native
from dynslam_tpu_torch.native import fastio

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
    raw = rows[:, 1:].reshape(h, w, bpp)
    img = fastio.png_unfilter(raw, rows[:, 0]) \
        if native.mode() == "native" else _unfilter(raw, rows[:, 0])
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


def read_png_gray(path: str) -> np.ndarray:
    """An 8-bit PNG as (H, W) uint8 gray: ``cv2.imread(path,
    IMREAD_GRAYSCALE)``. OpenCV asks libpng for ``png_set_rgb_to_gray(1,
    0.299, 0.587)``, whose 15-bit weights (9797, 19234, 3737) truncate;
    a gray file comes back as it is."""
    rgb = read_png(path).astype(np.int32)
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2])
            >> 15).astype(np.uint8)


def bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)`` for (H, W, 3) uint8 in
    BGR order: OpenCV's 15-bit fixed-point weights (B 3735, G 19235, R
    9798), rounded."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"bgr_to_gray: (H, W, 3) uint8, not {img.shape} "
                         f"{img.dtype}")
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + (1 << 14)) >> 15).astype(
        np.uint8)


def _area_fast(img: np.ndarray, dh: int, dw: int, sx: int, sy: int):
    """OpenCV's ``resizeAreaFast_`` at integer factors (sx, sy): a whole
    block averages as ``(sum + 2) >> 2`` at 2x2 (the vector path, 1, 3
    or 4 channels) and as ``sum * (1.f / area)`` rounded otherwise; a
    block cut by the image's right or bottom edge as ``(float)sum /
    count`` over its pixels inside, rounded."""
    h, w, cn = img.shape
    hh, ww = dh * sy, dw * sx
    pad = np.zeros((max(hh, h), max(ww, w), cn), np.int64)
    pad[:h, :w] = img
    inside = np.zeros(pad.shape[:2], np.int64)
    inside[:h, :w] = 1
    s = pad[:hh, :ww].reshape(dh, sy, dw, sx, cn).sum((1, 3))
    n = inside[:hh, :ww].reshape(dh, sy, dw, sx).sum((1, 3))[..., None]
    if (sx, sy) == (2, 2) and cn in (1, 3, 4):
        whole = (s + 2) >> 2
    else:
        whole = np.rint(s.astype(np.float32)
                        * (np.float32(1) / np.float32(sx * sy)))
    cut = np.rint(s.astype(np.float32) / np.maximum(n, 1).astype(np.float32))
    cut = np.where(n > 0, cut, 0)
    full = np.zeros((dh, dw, 1), bool)
    full[:h // sy, :w // sx] = True
    return np.clip(np.where(full, whole, cut), 0, 255).astype(np.uint8)


def _area_table(src: int, dst: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: (destination index, source
    index, float32 weight) of every tap, in OpenCV's order."""
    tab = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - f1) / cell)))
        tab += [(d, s, np.float32(1.0 / cell)) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                          / cell)))
    return tab


def _weighted_rows(tab, n: int, rows, src_axis_rows):
    """out[d] = sum over d's taps, in table order, of weight * row(src),
    in float32 with one rounding per product and per sum (OpenCV's
    ``ResizeArea_Invoker`` loop): ``rows(src_indices)`` gives the rows."""
    pos, seen = [], {}
    for d, _, _ in tab:
        pos.append(seen.get(d, 0))
        seen[d] = pos[-1] + 1
    out = None
    for p in range(max(pos) + 1):
        sel = [t for t, q in zip(tab, pos) if q == p]
        d = np.asarray([t[0] for t in sel])
        s = np.asarray([t[1] for t in sel])
        a = np.asarray([t[2] for t in sel], np.float32)
        term = src_axis_rows(s) * a.reshape((-1,) + (1,) * (rows - 1))
        if out is None:
            out = np.zeros((n,) + term.shape[1:], np.float32)
            out[d] = term
        else:
            out[d] = out[d] + term
    return out


def resize_area(src: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
                fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(src, dsize, fx=fx, fy=fy, interpolation=INTER_AREA)``
    for shrinking (H, W) or (H, W, C) uint8: ``dsize`` (width, height), or
    None to scale by (fx, fy) with the size rounded half to even. Integer
    factors take OpenCV's block-average path (``_area_fast``), others
    its area tables, accumulated in float32 in OpenCV's order and rounded
    half to even."""
    src = np.asarray(src)
    if src.dtype != np.uint8 or src.ndim not in (2, 3):
        raise ValueError(f"resize_area: (H, W[, C]) uint8, not {src.shape} "
                         f"{src.dtype}")
    h, w = src.shape[:2]
    if dsize is None:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize_area: dsize or positive fx, fy")
        dw, dh = int(round(w * fx)), int(round(h * fy))
    else:
        dw, dh = dsize
        fx, fy = dw / w, dh / h
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_area: empty destination {dw}x{dh}")
    scale_x, scale_y = 1.0 / fx, 1.0 / fy
    if scale_x < 1 or scale_y < 1:
        raise ValueError("resize_area: only shrinking is OpenCV's area rule")
    img = src.reshape(h, w, -1)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        out = _area_fast(img, dh, dw, ix, iy)
    else:
        cols = _weighted_rows(_area_table(w, dw, scale_x), dw, 3,
                              lambda s: img[:, s].transpose(1, 0, 2)
                              .astype(np.float32))  # (dw, h, cn)
        cols = cols.transpose(1, 0, 2)  # (h, dw, cn)
        acc = _weighted_rows(_area_table(h, dh, scale_y), dh, 3,
                             lambda s: cols[s])
        out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + src.shape[2:])
