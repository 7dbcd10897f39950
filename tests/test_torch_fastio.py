"""The port's native readers (``dynslam_tpu_torch/native``: ``fastio.cpp``
behind a plain C ABI, loaded with ctypes) three ways on this host: against
their numpy twins, against the JAX package's extension
``dynslam_tpu.native.fastio`` (called from this test only), and, for the
PNG row unfilter, against ``cv2.imread``. The cases mirror
``tests/test_native_and_prefetch.py``'s; all results are byte-equal."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from dynslam_tpu.native import fastio as jfastio
from dynslam_tpu_torch import native
from dynslam_tpu_torch.io import images
from dynslam_tpu_torch.io import segmentation as seg
from dynslam_tpu_torch.io import velodyne
from dynslam_tpu_torch.native import build, fastio
from dynslam_tpu_torch.utils import pfm

H, W = 37, 53


@pytest.fixture(autouse=True)
def native_mode(monkeypatch):
    monkeypatch.delenv(native.SWITCH, raising=False)


@pytest.mark.parametrize("fmt", ["%.18e", "%d"], ids=["float", "int"])
def test_mask_parity(tmp_path, fmt):
    mask = (np.random.default_rng(0).random((64, 80)) > 0.4).astype(np.uint8)
    p = str(tmp_path / "m.txt")
    np.savetxt(p, mask, fmt=fmt)
    got = fastio.read_text_mask(p, 64, 80)
    assert got.dtype == np.uint8 and np.array_equal(got, mask)
    assert np.array_equal(got, seg.read_mask_numpy(p, 80, 64))
    assert np.array_equal(got, jfastio.read_text_mask(p, 64, 80))
    assert np.array_equal(
        seg.PrecomputedSegmentationProvider._read_mask(p, 80, 64), mask)


@pytest.mark.parametrize("text,h,w,match", [
    ("1 1 1 1\n" * 4, 5, 5, "expected 5x5"),
    ("1 1\n1 1 1\n", 2, 2, "expected 2x2"),
    ("1 0 hello 1\n", 2, 2, "bad token"),
], ids=["shape", "ragged", "garbage"])
def test_mask_errors(tmp_path, text, h, w, match):
    p = tmp_path / "m.txt"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        fastio.read_text_mask(str(p), h, w)
    with pytest.raises(ValueError):
        seg.read_mask_numpy(str(p), w, h)
    if match != "expected 2x2":  # JAX's parser counts values, not rows
        with pytest.raises(ValueError):
            jfastio.read_text_mask(str(p), h, w)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("order", ["<", ">"], ids=["little", "big"])
def test_pfm_parity(tmp_path, channels, order):
    shape = (6, 9) if channels == 1 else (6, 9, 3)
    img = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    p = str(tmp_path / "x.pfm")
    with open(p, "wb") as f:
        f.write(b"PF\n" if channels == 3 else b"Pf\n")
        f.write(b"9 6\n" + (b"-1.0\n" if order == "<" else b"1.0\n"))
        np.flipud(img).astype(order + "f4").tofile(f)
    got = fastio.read_pfm(p)
    assert got.dtype == np.float32 and np.array_equal(got, img)
    assert np.array_equal(got, pfm.read_pfm_numpy(p))
    assert np.array_equal(got, jfastio.read_pfm(p))


def test_pfm_written_by_write_pfm(tmp_path):
    img = np.random.default_rng(2).normal(size=(H, W)).astype(np.float32)
    p = str(tmp_path / "x.pfm")
    pfm.write_pfm(p, img)
    assert np.array_equal(pfm.read_pfm(p), img)
    assert np.array_equal(pfm.read_pfm(p), jfastio.read_pfm(p))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n255\n")
    with pytest.raises(ValueError, match="not a PFM"):
        fastio.read_pfm(str(tmp_path / "bad.pfm"))


def test_velodyne_parity(tmp_path):
    pts = np.random.default_rng(3).normal(size=(1000, 4)).astype(np.float32)
    p = str(tmp_path / "000000.bin")
    pts.tofile(p)
    got = fastio.read_velodyne(p)
    assert np.array_equal(got, pts)
    assert np.array_equal(got, velodyne.read_numpy(p))
    assert np.array_equal(got, jfastio.read_velodyne(p))
    assert np.array_equal(velodyne.VelodyneIO(str(tmp_path)).read_frame(0),
                          pts)


def test_velodyne_corrupt(tmp_path):
    p = tmp_path / "v.bin"
    p.write_bytes(b"\x00" * 13)
    for read in (fastio.read_velodyne, velodyne.read_numpy,
                 jfastio.read_velodyne):
        with pytest.raises(ValueError, match="corrupt"):
            read(str(p))


@pytest.mark.parametrize("read", [
    lambda p: fastio.read_text_mask(p, 2, 2), fastio.read_pfm,
    fastio.read_velodyne, lambda p: jfastio.read_text_mask(p, 2, 2),
], ids=["mask", "pfm", "velodyne", "jax-mask"])
def test_missing_file(read):
    with pytest.raises(FileNotFoundError):
        read("/nonexistent/m.txt")


def _filtered(img: np.ndarray, filters) -> bytes:
    """PNG scanlines of ``img`` (H, W, bpp), row r filtered with
    ``filters[r]`` by the spec's rules."""
    h, w, bpp = img.shape
    flat = img.reshape(h, -1).astype(np.int64)
    out = []
    for r in range(h):
        row = flat[r]
        b = flat[r - 1] if r else np.zeros_like(row)
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
        k = filters[r]
        p = a + b - c
        paeth = np.where((abs(p - a) <= abs(p - b)) & (abs(p - a)
                                                       <= abs(p - c)),
                         a, np.where(abs(p - b) <= abs(p - c), b, c))
        pred = [0, a, b, (a + b) // 2, paeth][k]
        out.append(np.concatenate([[k], (row - pred) % 256]))
    return np.stack(out).astype(np.uint8).tobytes()


def _png(path, img, filters):
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    ctype = {1: 0, 3: 2, 4: 6}[img.shape[2]]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", img.shape[1], img.shape[0], 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(_filtered(img, filters)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("bpp", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "cycle"])
def test_png_unfilter(tmp_path, bpp, ftype):
    """Rows of one filter (or all five in turn), hand-set filter bytes:
    the native unfilter equals ``_unfilter`` and ``cv2.imread``."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (H, W, bpp), dtype=np.uint8)
    img[: H // 2] //= 7  # small values: Average and Paeth ties
    filters = [r % 5 if ftype == "cycle" else ftype for r in range(H)]
    raw = np.frombuffer(zlib.decompress(zlib.compress(
        _filtered(img, filters))), np.uint8).reshape(H, 1 + W * bpp)
    got = fastio.png_unfilter(raw[:, 1:].reshape(H, W, bpp), raw[:, 0])
    assert np.array_equal(got, img)
    assert np.array_equal(got, images._unfilter(
        raw[:, 1:].reshape(H, W, bpp), raw[:, 0]))
    path = str(tmp_path / "f.png")
    _png(path, img, filters)
    want = cv2.imread(path)[..., ::-1]
    assert np.array_equal(images.read_png(path), want)


def test_png_unknown_filter():
    raw = np.zeros((2, 1 + 3), np.uint8)
    raw[1, 0] = 7
    with pytest.raises(ValueError, match="unknown row filter 7"):
        fastio.png_unfilter(raw[:, 1:].reshape(2, 3, 1), raw[:, 0])


def test_switch_selects_numpy(tmp_path, monkeypatch):
    """``DYNSLAM_NO_NATIVE_BUILD`` set: every reader takes its numpy twin
    and the library is never asked for."""
    monkeypatch.setenv(native.SWITCH, "1")
    assert native.mode() == "numpy"

    def refuse():
        raise AssertionError("the native library was used")
    monkeypatch.setattr(fastio, "library", refuse)
    mask = np.eye(4, 6, dtype=np.uint8)
    np.savetxt(tmp_path / "m.txt", mask, fmt="%d")
    assert np.array_equal(seg.PrecomputedSegmentationProvider._read_mask(
        str(tmp_path / "m.txt"), 6, 4), mask)
    pfm.write_pfm(str(tmp_path / "x.pfm"), mask.astype(np.float32))
    assert np.array_equal(pfm.read_pfm(str(tmp_path / "x.pfm")), mask)
    np.ones((3, 4), np.float32).tofile(tmp_path / "000000.bin")
    assert velodyne.VelodyneIO(str(tmp_path)).read_frame(0).shape == (3, 4)
    images.write_png(str(tmp_path / "i.png"), mask * 200)
    assert np.array_equal(images.read_png(str(tmp_path / "i.png"))[..., 0],
                          mask * 200)


def test_native_is_the_default():
    assert native.mode() == "native"
    fastio.library()
    assert native.available()


def test_broken_compiler_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's complaint; a reader does
    not fall back to numpy."""
    with pytest.raises(RuntimeError, match="cannot run"):
        build.build(tmp_path, compiler=str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    fastio.library.cache_clear()
    try:
        np.ones((3, 4), np.float32).tofile(tmp_path / "000000.bin")
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
            velodyne.VelodyneIO(str(tmp_path)).read_frame(0)
        assert not native.available()
    finally:
        fastio.library.cache_clear()
