"""Image files read as OpenCV reads them: PNG through ``utils/png.py``,
baseline JPEG through the native decoder (``native/jpeg.cpp``).

The JAX package reads every image with ``cv2.imread`` / ``cv2.imdecode``; the
port reads them here, without OpenCV or PIL, and picks the decoder by the
file's signature, not its name:

- ``read_rgb`` / ``decode_rgb``: (H, W, 3) uint8 RGB, as
  ``cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``;
- ``read_gray``: (H, W) uint8, as ``cv2.imread(path,
  cv2.IMREAD_GRAYSCALE)``. For a colour JPEG that is the decoded Y plane
  (libjpeg's grey output); for a colour PNG the BT.601 mix of
  ``png.read_gray``.

A JPEG mode the decoder does not take (progressive, arithmetic, lossless,
12-bit, CMYK) or a truncated file raises ``ValueError`` naming the file;
OpenCV decodes the first four and pads the last. A missing file raises
``FileNotFoundError``.
"""
from __future__ import annotations

import numpy as np

from .. import native
from . import png

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"


def _kind(head: bytes) -> str:
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(JPEG_SIGNATURE):
        return "jpeg"
    return "other"


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG held in memory (a tar member)."""
    return _decode(bytes(data), name, gray=False)


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG file."""
    return _read(path, gray=False)


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8 of a JPEG or PNG file."""
    return _read(path, gray=True)


def _read(path: str, gray: bool) -> np.ndarray:
    with open(path, "rb") as f:
        return _decode(f.read(), path, gray)


def _decode(data: bytes, name: str, gray: bool) -> np.ndarray:
    kind = _kind(data[:8])
    if kind == "jpeg":
        try:
            return native.jpeg_decode(data, gray=gray)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    if kind == "png":
        img = png.decode_png(data, name)
        return png.as_gray(img) if gray else png.as_rgb(img)
    raise ValueError(f"{name}: neither a PNG nor a JPEG file (the port reads those two)")
