"""Native (C++) host kernels of evaluation, compiled on first use and loaded
through ctypes.

Counterpart of ``divergen_tpu/native/__init__.py``: greedy COCO matching and
the RLE mask IoU (``cocoeval.cpp``), the fused paste + RLE encode of a
detection mask and the RLE string codec (``mask_codec.cpp``; both files are
copies of the JAX package's), plus the polygon fill of ``cv2.fillPoly``
(``polygon_fill.cpp``) and the outer borders of ``cv2.findContours``
(``contours.cpp``), which the JAX package takes from OpenCV.

The four sources are built with ``g++ -O3 -shared -fPIC -std=c++17`` into
one library under ``build/native/`` at the root of the checkout, named by a
hash of the sources, so an edit builds a new one. Nothing is built at import
time. A failed build raises: there is no numpy fallback here (the JAX package
falls back with a warning). The numpy versions of these functions are the
plain twins the tests hold them against (``greedy_match_np`` and
``mask_iou_np`` in ``evaluation/coco_eval_np.py``, ``paste_mask_np`` +
``rle_encode``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ("cocoeval.cpp", "mask_codec.cpp", "polygon_fill.cpp",
                               "contours.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdg_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the one for these sources is missing."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native evaluation library cannot be built: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {res.returncode}:\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.greedy_match.argtypes = [p, i64, i64, p, p, p, i64, p, p]
    lib.greedy_match.restype = None
    lib.rle_iou.argtypes = [p, p, i64, p, p, i64, p, p]
    lib.rle_iou.restype = None
    lib.rle_from_string.argtypes = [ctypes.c_char_p, i64, p]
    lib.rle_from_string.restype = i64
    lib.paste_mask_rle.argtypes = [p, i64, i64, p, i64, i64, ctypes.c_float, p, i64]
    lib.paste_mask_rle.restype = i64
    lib.rle_counts_to_string.argtypes = [p, i64, ctypes.c_char_p, i64]
    lib.rle_counts_to_string.restype = i64
    lib.rle_string_to_counts.argtypes = [ctypes.c_char_p, i64, p, i64]
    lib.rle_string_to_counts.restype = i64
    lib.fill_polygon.argtypes = [p, i64, i64, p, i64]
    lib.fill_polygon.restype = i64
    lib.external_contours.argtypes = [p, i64, i64, p, i64, p, i64, p]
    lib.external_contours.restype = i64


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            _declare(loaded)
            _lib = loaded
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def greedy_match(ious: np.ndarray, g_ignore: np.ndarray, iscrowd: np.ndarray,
                 thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, D) matched gt index + 1 (0: unmatched) and ignore flags."""
    lib = get_lib()
    D, G = ious.shape
    T = len(thrs)
    if len(g_ignore) != G or len(iscrowd) != G:
        raise ValueError(f"greedy_match: {G} gts, {len(g_ignore)} ignore and "
                         f"{len(iscrowd)} crowd flags")
    ious = np.ascontiguousarray(ious, np.float64)
    gi = np.ascontiguousarray(g_ignore, np.uint8)
    ic = np.ascontiguousarray(iscrowd, np.uint8)
    th = np.ascontiguousarray(thrs, np.float64)
    matched = np.zeros((T, D), np.int64)
    dt_ig = np.zeros((T, D), np.uint8)
    lib.greedy_match(_ptr(ious), D, G, _ptr(gi), _ptr(ic), _ptr(th), T, _ptr(matched),
                     _ptr(dt_ig))
    return matched, dt_ig.astype(bool)


def _runs_of(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if isinstance(counts, bytes):
        buf = np.zeros(len(counts) + 1, np.uint32)
        n = get_lib().rle_from_string(counts, len(counts), _ptr(buf))
        return buf[:n]
    return np.asarray(counts, np.uint32)


def rle_iou_matrix(dets: List[dict], gts: List[dict], iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of compressed RLEs without decoding them."""
    lib = get_lib()
    out = np.zeros((len(dets), len(gts)), np.float64)
    if not dets or not gts:
        return out
    if len(iscrowd) != len(gts):
        raise ValueError(f"rle_iou_matrix: {len(gts)} gts, {len(iscrowd)} crowd flags")
    d_runs = [_runs_of(r) for r in dets]
    g_runs = [_runs_of(r) for r in gts]
    d_off = np.zeros(len(d_runs) + 1, np.int64)
    np.cumsum([len(r) for r in d_runs], out=d_off[1:])
    g_off = np.zeros(len(g_runs) + 1, np.int64)
    np.cumsum([len(r) for r in g_runs], out=g_off[1:])
    ic = np.ascontiguousarray(iscrowd, np.uint8)
    lib.rle_iou(_ptr(np.ascontiguousarray(np.concatenate(d_runs))), _ptr(d_off), len(dets),
                _ptr(np.ascontiguousarray(np.concatenate(g_runs))), _ptr(g_off), len(gts),
                _ptr(ic), _ptr(out))
    return out


def paste_mask_rle(prob: np.ndarray, box: np.ndarray, h: int, w: int,
                   thresh: float = 0.5) -> dict:
    """Fused paste + compressed-RLE encode of one detection mask: equal to
    ``rle_encode(paste_mask_np(prob, box, h, w))`` without the (h, w) canvas.
    Returns a pycocotools-style ``{"size", "counts": str}``."""
    lib = get_lib()
    prob = np.ascontiguousarray(prob, np.float32)
    box = np.ascontiguousarray(box, np.float32).reshape(-1)
    if prob.ndim != 2 or box.size != 4:
        raise ValueError(f"paste_mask_rle: a 2-D probability map and 4 box values, got "
                         f"{prob.shape} and {box.size}")
    # a column's bilinear profile crosses the threshold at most once per
    # segment between crop rows, so ~2 mh + 4 runs a column; h w + 1 always holds
    for cap in (int(w) * (2 * int(prob.shape[0]) + 4) + 16, int(h) * int(w) + 2):
        counts = np.zeros(cap, np.int64)
        m = lib.paste_mask_rle(_ptr(prob), prob.shape[0], prob.shape[1], _ptr(box), h, w,
                               ctypes.c_float(thresh), _ptr(counts), cap)
        if m >= 0:
            break
    else:
        raise RuntimeError(f"paste_mask_rle: more than {cap} runs in an ({h}, {w}) mask")
    scap = int(m) * 12 + 16  # a count takes at most 7 characters
    s = ctypes.create_string_buffer(scap)
    n = lib.rle_counts_to_string(_ptr(counts), m, s, scap)
    if n < 0:
        raise RuntimeError("rle_counts_to_string: the string buffer is too small")
    return {"size": [int(h), int(w)], "counts": s.raw[: int(n)].decode()}


def fill_polygon(mask: np.ndarray, pts: np.ndarray) -> None:
    """OR one polygon of integer vertices ((n, 2) as x, y; n >= 1) into a
    uint8 (h, w) mask, with the pixels ``cv2.fillPoly(mask, [pts], 1)`` sets."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags.c_contiguous:
        raise ValueError("mask: a C-contiguous (h, w) uint8 array")
    pts = np.ascontiguousarray(pts, np.int64).reshape(-1, 2)
    if not len(pts):  # cv2.fillPoly asserts on an empty contour
        raise ValueError("fill_polygon: a polygon without vertices")
    get_lib().fill_polygon(_ptr(mask), mask.shape[0], mask.shape[1], _ptr(pts), len(pts))


def external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """The outer borders of a 2-D mask (nonzero = set), each an (n, 2) int64
    array of (x, y) points, as ``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)`` returns them: the same points in the same
    order, and the contours in its order."""
    if mask.ndim != 2:
        raise ValueError(f"external_contours: a 2-D mask, got {mask.shape}")
    m = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = m.shape
    lib = get_lib()
    cap_pts, cap_counts = 4 * (h + w) + 16, 64
    while True:
        pts = np.zeros((cap_pts, 2), np.int64)
        counts = np.zeros(cap_counts, np.int64)
        total = ctypes.c_int64(0)
        n = lib.external_contours(_ptr(m), h, w, _ptr(pts), cap_pts, _ptr(counts), cap_counts,
                                  ctypes.byref(total))
        if n <= cap_counts and total.value <= cap_pts:
            break
        cap_pts, cap_counts = max(cap_pts, int(total.value)), max(cap_counts, int(n))
    ends = np.cumsum(counts[:n])
    return [pts[e - c:e] for c, e in zip(counts[:n], ends)]


def contour_area(pts: np.ndarray) -> float:
    """``cv2.contourArea`` of integer points: the shoelace sum in float64
    over the points as given, halved, made positive."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    if not len(pts):
        return 0.0
    prev = np.roll(pts, 1, axis=0)
    return abs(float(np.sum(prev[:, 0] * pts[:, 1] - prev[:, 1] * pts[:, 0])) * 0.5)
