"""COCO-compatible mask codec: polygon rasterization + compressed RLE.

Counterpart of ``divergen_tpu/utils/mask_codec.py``; every function but
``polygons_to_bitmask`` is a copy. The RLE byte format is bit-compatible with
pycocotools' LEB128-style encoding. Column-major (Fortran) order, like COCO.
The JAX package rasterizes polygons with ``cv2.fillPoly``; the port fills
them with the native library's copy of that algorithm
(``native/polygon_fill.cpp``), which sets the same pixels.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def polygons_to_bitmask(polygons: Sequence[np.ndarray], height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygons ([x0,y0,x1,y1,...] lists) to a bool mask.

    The union of the polygons, each filled as ``cv2.fillPoly`` fills its
    vertices rounded to int32 (outline included)."""
    from ..native import fill_polygon

    mask = np.zeros((height, width), np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        fill_polygon(mask, np.round(pts).astype(np.int32))
    return mask.astype(bool)


def rle_encode(mask: np.ndarray) -> Dict:
    """bool (H,W) → {"size": [H,W], "counts": bytes} compressed RLE
    (pycocotools rleToString format)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.int8)
    # run lengths of alternating 0s/1s, starting with 0s
    diffs = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": _counts_to_string(runs)}


def rle_decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        runs = _string_to_counts(counts)
    else:
        runs = list(counts)
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for r in runs:
        if val:
            flat[pos : pos + r] = True
        pos += r
        val = not val
    return flat.reshape((h, w), order="F")


def _counts_to_string(runs: List[int]) -> bytes:
    """pycocotools rleToString: delta-coded LEB128-ish ASCII encoding."""
    out = bytearray()
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _string_to_counts(s: Union[bytes, str]) -> List[int]:
    if isinstance(s, str):
        s = s.encode()
    runs: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    return runs


def rle_area(rle: Dict) -> int:
    runs = (
        _string_to_counts(rle["counts"])
        if isinstance(rle["counts"], (bytes, str))
        else list(rle["counts"])
    )
    return int(sum(runs[1::2]))


def mask_to_box(mask: np.ndarray) -> np.ndarray:
    """bool (H,W) → [x1,y1,x2,y2] (x2/y2 exclusive); zeros if empty."""
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)
