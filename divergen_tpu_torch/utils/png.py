"""A small PNG writer and reader on the standard library (zlib + struct).

The writer stores 8-bit RGB, RGBA or gray, the pixels ``cv2.imwrite`` would
store for the same array (RGB given as RGB, not BGR). The reader decodes
8-bit gray, RGB and RGBA, non-interlaced, with all five scanline filters. So
the port needs neither OpenCV nor PIL. There is no JPEG decoder.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type → samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) uint8 RGB, (H, W, 4) uint8 RGBA, or (H, W) uint8 gray."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"expected (H, W, 3), (H, W, 4) or (H, W) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    color_type = {3: 2, 4: 6}[img.shape[2]] if img.ndim == 3 else 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + W·bpp) filtered scanlines → (H, W·bpp) bytes. Sub and Up are
    vectorized; Average and Paeth depend on the pixel to the left and run
    pixel by pixel."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int64)
        if kind == 1:  # Sub: running sum per channel
            line = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1)
        elif kind == 2:  # Up
            line = line + prev
        elif kind in (3, 4):
            for x in range(stride):
                a = line[x - bpp] if x >= bpp else 0
                b = prev[x]
                if kind == 3:  # Average
                    pred = (a + b) >> 1
                else:  # Paeth
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
        elif kind != 0:
            raise ValueError(f"PNG filter type {kind}")
        prev = line & 0xFF
        out[y] = prev
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG: (H, W) uint8 for gray, (H, W, 3)
    for RGB, (H, W, 4) for RGBA."""
    if path.lower().endswith((".jpg", ".jpeg")):
        raise ValueError(f"{path}: JPEG input is not supported (the port decodes images "
                         "without OpenCV or PIL); convert it to PNG")
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit gray / RGB / RGBA, non-interlaced PNGs are "
                         f"read (bit depth {depth}, color type {color_type}, "
                         f"interlace {interlace})")
    bpp = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for {w}x{h}x{bpp}")
    raw = raw.reshape(h, 1 + w * bpp)
    pixels = raw[:, 1:] if not raw[:, 0].any() else _unfilter(raw, bpp)
    return pixels.reshape((h, w) if bpp == 1 else (h, w, bpp)).copy()


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB whatever the file's color type (alpha dropped)."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8: gray as stored (what ``cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)`` gives), color through the BT.601 weights (within
    one gray level of OpenCV's fixed-point conversion)."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.float32)
    return np.round(rgb @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)
