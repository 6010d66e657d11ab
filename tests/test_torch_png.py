"""The port's PNG reader and writer (``utils/png.py``) against OpenCV and
against scanlines filtered by hand with each of the five filter types."""
import struct
import zlib

import cv2
import numpy as np
import pytest

from divergen_tpu_torch.utils import png


def _encode(img: np.ndarray, filter_type: int) -> bytes:
    """A PNG whose every scanline uses ``filter_type``."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if filter_type == 0:
            pred = 0
        elif filter_type == 1:
            pred = left
        elif filter_type == 2:
            pred = prev
        elif filter_type == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(filter_type)
        out += bytes(((cur - pred) & 0xFF).astype(np.uint8))
        prev = cur
    color_type = {1: 0, 3: 2, 4: 6}[bpp]
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (7, 5, 4)])
def test_read_png_all_filters(tmp_path, filter_type, shape):
    img = np.random.RandomState(filter_type).randint(0, 256, shape).astype(np.uint8)
    path = tmp_path / "a.png"
    path.write_bytes(_encode(img, filter_type))
    np.testing.assert_array_equal(png.read_png(str(path)), img)


@pytest.mark.parametrize("shape", [(20, 31), (37, 53, 3), (16, 9, 4)])
def test_read_png_matches_opencv(tmp_path, shape):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)  # OpenCV stores BGR(A)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[..., [2, 1, 0, 3][: want.shape[2]]]
    np.testing.assert_array_equal(png.read_png(path), want)
    assert png.read_rgb(path).shape == shape[:2] + (3,)
    gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(int)
    assert np.abs(png.read_gray(path).astype(int) - gray).max() <= 1  # fixed-point BT.601


@pytest.mark.parametrize("shape", [(12, 17), (12, 17, 3), (12, 17, 4)])
def test_write_png_read_back_by_opencv(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if back.ndim == 2 else back[..., [2, 1, 0, 3][:shape[2]]],
                                  img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_jpeg_and_16_bit_raise(tmp_path):
    with pytest.raises(ValueError, match="JPEG"):
        png.read_png(str(tmp_path / "a.jpg"))
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        png.read_png(path)
