"""The port's image and matrix files (``dynslam_tpu_torch/io/images.py``)
against OpenCV, byte for byte: PNG read (every compression level cv2
writes, and a file holding all five row filters) and write, OpenCV XML
``FileStorage`` read and write, the nearest and area resizes, the gray
conversions (``cvtColor`` and ``imread``'s gray read); and the PFM copy
against the JAX package's ``utils/pfm.py``. ``resize_area`` is byte-exact
at integer factors and at the area-table factors below alike."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from dynslam_tpu.io.synthetic import write_kitti_sequence
from dynslam_tpu.utils import pfm as jpfm
from dynslam_tpu_torch.io import images
from dynslam_tpu_torch.utils import pfm as tpfm

H, W = 37, 53


def _images():
    rng = np.random.default_rng(0)
    base = (np.add.outer(np.arange(H), np.arange(W)) * 3 % 256).astype(
        np.uint8)
    rgb = np.stack([base, base[::-1], rng.integers(0, 256, base.shape,
                                                   dtype=np.uint8)], -1)
    rgba = np.concatenate(
        [rgb, rng.integers(0, 256, (H, W, 1), dtype=np.uint8)], -1)
    return {"gray": base, "bgr": rgb, "bgra": rgba}


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra"])
def test_png_reader_equals_cv2_imread(tmp_path, kind):
    """cv2.imread(IMREAD_COLOR) as RGB, at every compression level (cv2
    picks Sub, Up, Average and Paeth rows among them)."""
    img = _images()[kind]
    seen = set()
    for level in range(10):
        path = str(tmp_path / f"{kind}{level}.png")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        want = cv2.imread(path)[..., ::-1]
        assert np.array_equal(images.read_png(path), want), level
        assert images.png_size(path) == (W, H)
        chunks = dict(images._chunks(open(path, "rb").read()))
        ch = img.shape[2] if img.ndim == 3 else 1
        rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
        seen |= set(rows.reshape(H, 1 + W * ch)[:, 0].tolist())
    if kind != "gray":
        assert {3, 4} <= seen, seen


def _filter_row(kind, row, prev, bpp):
    """One PNG row filtered with filter type ``kind`` (the spec's rules)."""
    row, prev = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    b = prev
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((row - pred) % 256).astype(np.uint8)


def test_every_row_filter(tmp_path):
    """A file whose rows cycle through all five filters reads as cv2
    reads it."""
    img = _images()["bgr"][..., ::-1]  # RGB on disk
    flat = img.reshape(H, -1)
    rows = []
    for r in range(H):
        prev = flat[r - 1] if r else np.zeros_like(flat[0])
        rows.append(np.concatenate([[r % 5], _filter_row(r % 5, flat[r],
                                                         prev, 3)]))
    raw = np.stack(rows).astype(np.uint8).tobytes()

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    want = cv2.imread(path)[..., ::-1]
    assert np.array_equal(want, img)
    assert np.array_equal(images.read_png(path), want)


def test_png_writer_reads_back_in_cv2(tmp_path):
    for name, img in _images().items():
        if name == "bgra":
            continue
        path = str(tmp_path / f"{name}.png")
        images.write_png(path, img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        want = img if img.ndim == 2 else img[..., ::-1]
        assert np.array_equal(back, want), name
        assert np.array_equal(images.read_png(path),
                              img if img.ndim == 3 else np.repeat(
                                  img[..., None], 3, 2))


@pytest.mark.parametrize("shape", [(H, W), (5, 1), (1, 9), (375, 1242)],
                         ids=["small", "one-column", "one-row", "kitti"])
@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
def test_png_writer_bytes_equal_cv2_imwrite(tmp_path, shape, channels):
    """cv2.imwrite's bytes at its defaults (Sub rows, zlib level 1 with
    the run-length strategy, libpng's window and chunking), from a
    smooth gradient with noise (KITTI size: several IDAT chunks)."""
    rng = np.random.default_rng(shape[0] * 7 + channels)
    h, w = shape
    grad = np.add.outer(np.arange(h), np.arange(w))[..., None] \
        + 40 * np.arange(channels)
    img = ((grad + rng.integers(0, 3, grad.shape)) % 256).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    mine, theirs = str(tmp_path / "mine.png"), str(tmp_path / "cv2.png")
    images.write_png(mine, img)
    assert cv2.imwrite(theirs, img if channels == 1 else img[..., ::-1])
    assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_opencv_xml_bytes_equal_cv2(tmp_path):
    """cv2.FileStorage's bytes for int16 depth in mm, values of every width
    (the line breaks fall where cv2 breaks them)."""
    rng = np.random.default_rng(5)
    depth = rng.choice([0, 7, 512, 4096, 20000, -3, 32767],
                       size=(23, 41)).astype(np.int16)
    mine, theirs = str(tmp_path / "mine.xml"), str(tmp_path / "cv2.xml")
    images.write_opencv_xml(mine, "depth", depth)
    fs = cv2.FileStorage(theirs, cv2.FILE_STORAGE_WRITE)
    fs.write("depth", depth)
    fs.release()
    assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_png_reader_rejects_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, (np.arange(W * H).reshape(H, W) * 7).astype(np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        images.read_png(path)


def test_opencv_xml_against_cv2(tmp_path):
    """The reader equals cv2.FileStorage on JAX-written ELAS dumps, and
    cv2 reads the port's dumps back equal."""
    root = str(tmp_path / "seq")
    write_kitti_sequence(root, num_frames=2, width=64, height=48)
    for f in range(2):
        path = f"{root}/precomputed-depth/Frames/{f:04d}.xml"
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        want = fs.getNode(fs.root().keys()[0]).mat()
        fs.release()
        got = images.read_opencv_xml(path)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        mine = str(tmp_path / f"mine{f}.xml")
        images.write_opencv_xml(mine, "depth", want.astype(np.int16))
        fs = cv2.FileStorage(mine, cv2.FILE_STORAGE_READ)
        back = fs.getNode("depth").mat()
        fs.release()
        assert back.dtype == np.int16 and np.array_equal(back, want)


def test_opencv_xml_of_other_layouts(tmp_path):
    """The OpenCV 4 letter for CV_16U ("w") and data on one line."""
    path = str(tmp_path / "w.xml")
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<opencv_storage>\n<Frame '
                'type_id="opencv-matrix"><rows>2</rows><cols>3</cols>'
                '<dt>w</dt><data>0 1 2 3000 4 65</data></Frame>\n'
                '</opencv_storage>\n')
    got = images.read_opencv_xml(path)
    assert got.dtype == np.uint16
    assert got.tolist() == [[0, 1, 2], [3000, 4, 65]]


@pytest.mark.parametrize("fx", [0.5, 1 / 1.5, 1 / 3.0, 0.37, 1.25, 2.0])
def test_resize_nearest_by_factor(fx):
    """``Input``'s resize (fx = fy = 1 / scale, size rounded)."""
    img = np.random.default_rng(2).integers(0, 256, (75, 124, 3),
                                            dtype=np.uint8)
    want = cv2.resize(img, None, fx=fx, fy=fx,
                      interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(images.resize_nearest(img, None, fx, fx), want)


@pytest.mark.parametrize("dsize", [(77, 33), (13, 101), (53, 37), (160, 9)])
def test_resize_nearest_to_size(dsize):
    """The segmentation masks' resize to a bbox."""
    mask = (np.random.default_rng(3).random((37, 53)) > 0.5).astype(np.uint8)
    want = cv2.resize(mask, dsize, interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(images.resize_nearest(mask, dsize), want)


def _scene_image(shape):
    """Half noise, half a smooth ramp (area sums of every size)."""
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    ramp = np.linspace(0, 255, shape[1]).astype(np.uint8)[None]
    img[: shape[0] // 2] = ramp[..., None] if img.ndim == 3 else ramp
    return img


@pytest.mark.parametrize("shape", [(96, 192, 3), (97, 191, 3), (65, 81),
                                   (375, 1242, 3)],
                         ids=["even", "odd", "gray-odd", "kitti"])
@pytest.mark.parametrize("fx", [0.5, 0.25, 1 / 3.0, 0.4, 0.37, 0.7])
def test_resize_area_equals_cv2(shape, fx):
    """``scale_sequence``'s resize (fx = fy = the scale): integer factors
    (0.5, 0.25, 1/3) take OpenCV's block path, the rest its area
    tables; blocks cut by an odd edge average what lies inside."""
    img = _scene_image(shape)
    want = cv2.resize(img, None, fx=fx, fy=fx, interpolation=cv2.INTER_AREA)
    got = images.resize_area(img, None, fx, fx)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("dsize", [(96, 48), (50, 31)])
def test_resize_area_to_size(dsize):
    img = _scene_image((97, 191, 3))
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
    assert np.array_equal(images.resize_area(img, dsize), want)


def test_gray_conversions_equal_cv2(tmp_path):
    """``bgr_to_gray`` is ``cvtColor(BGR2GRAY)``; ``read_png_gray`` is
    ``imread(IMREAD_GRAYSCALE)`` (libpng's truncating weights), on a
    colour file and on a gray one."""
    img = _scene_image((375, 1242, 3))
    img[:9] = img[:9, :, :1]  # some pixels with equal channels
    want = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    assert np.array_equal(images.bgr_to_gray(img), want)
    for name, data in (("c.png", img), ("g.png", want)):
        path = str(tmp_path / name)
        assert cv2.imwrite(path, data)
        assert np.array_equal(images.read_png_gray(path),
                              cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_pfm_round_trips_against_jax(tmp_path):
    rng = np.random.default_rng(4)
    for shape in ((H, W), (H, W, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
        tpfm.write_pfm(a, img)
        jpfm.write_pfm(b, img)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert np.array_equal(tpfm.read_pfm(b), jpfm.read_pfm(b))
        assert np.array_equal(tpfm.read_pfm(a), img)
