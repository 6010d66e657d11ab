"""Write the JPEG fixtures under ``tests/data/jpeg/`` and their manifest.

The port's JPEG decoder (``divergen_tpu_torch/native/jpeg.cpp``) is held
against ``cv2.imdecode`` by the CPU tests. The machine with the card has no
OpenCV, so ``chip_smoke.py`` checks the decoder there against these files: the
manifest records, for each, its mode and size and the SHA-256 of the RGB
pixels ``cv2.imdecode`` (``IMREAD_COLOR``, then BGR -> RGB) gives, or the
``ValueError`` a mode the port refuses must raise.

- one small file per mode: the sampling factors 4:4:4, 4:2:2, 4:4:0, 4:2:0
  and 4:1:1 at odd sizes, restart markers, optimised Huffman tables, grey, an
  EXIF orientation, SOF1, and a progressive file the port refuses;
- six LVIS-sized images (640 x 480, 4:2:0, quality 90) of smooth synthetic
  content with a few filled polygons each, recorded as ``objects``
  (category, polygon): the training root and the ``lvis_crop`` input of the
  smoke run's real-image phase.

Needs OpenCV (the JAX package's reader); the output is deterministic for one
libjpeg build. Run from the root of the checkout:

    python tools/make_jpeg_fixtures.py [--out tests/data/jpeg]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct

import cv2
import numpy as np


def smooth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Low-frequency colour field plus mild noise, uint8 RGB."""
    grid = rng.random((max(h // 40, 2), max(w // 40, 2), 3)).astype(np.float32) * 255
    img = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC)
    img += rng.normal(0, 4, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def polygon(rng: np.random.Generator, cx: float, cy: float, r: float) -> np.ndarray:
    """A convex-ish polygon of 5-9 vertices around (cx, cy)."""
    n = int(rng.integers(5, 10))
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.6, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)


def encode(rgb: np.ndarray, params) -> bytes:
    bgr = rgb if rgb.ndim == 2 else cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(".jpg", bgr, [int(p) for p in params])
    assert ok
    return buf.tobytes()


def with_orientation(data: bytes, orientation: int) -> bytes:
    """An APP1 EXIF segment (little-endian TIFF, IFD0 Orientation) after SOI."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    app1 = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def as_sof1(data: bytes) -> bytes:
    """The same stream under an SOF1 (extended sequential) marker."""
    i = data.index(b"\xff\xc0")
    return data[:i] + b"\xff\xc1" + data[i + 2:]


def cv2_rgb(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join("tests", "data", "jpeg"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    q, sf = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    modes = [  # name, (h, w), mode, encoder params, post-processing
        ("s444_q75", (33, 17), "4:4:4", [q, 75, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], None),
        ("s422_q50", (47, 61), "4:2:2", [q, 50, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], None),
        ("s440_q95", (61, 47), "4:4:0", [q, 95, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440], None),
        ("s420_q100", (79, 101), "4:2:0", [q, 100, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
         None),
        ("s411_q75", (40, 71), "4:1:1", [q, 75, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411], None),
        ("s420_rst3", (65, 83), "4:2:0, restart interval 3",
         [q, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 3], None),
        ("s420_optimized", (64, 64), "4:2:0, optimised Huffman tables",
         [q, 85, cv2.IMWRITE_JPEG_OPTIMIZE, 1], None),
        ("grey_q75", (37, 29), "grey (1 component)", [q, 75], "grey"),
        ("exif6_q90", (30, 50), "4:2:0, EXIF orientation 6", [q, 90], "exif6"),
        ("sof1_q75", (24, 40), "4:2:0 under SOF1", [q, 75], "sof1"),
        ("progressive", (32, 48), "progressive (SOF2)", [q, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
         None),
    ]
    files = []
    for name, (h, w), mode, params, post in modes:
        img = smooth_image(rng, h, w)
        data = encode(img[..., 0] if post == "grey" else img, params)
        if post == "exif6":
            data = with_orientation(data, 6)
        elif post == "sof1":
            data = as_sof1(data)
        fname = f"{name}.jpg"
        with open(os.path.join(args.out, fname), "wb") as f:
            f.write(data)
        rgb = cv2_rgb(data)
        entry = {"file": fname, "mode": mode, "height": int(rgb.shape[0]),
                 "width": int(rgb.shape[1])}
        if name == "progressive":
            entry["raises"] = "progressive"
        else:
            entry["sha256_rgb"] = hashlib.sha256(rgb.tobytes()).hexdigest()
        files.append(entry)
    images = []
    for k in range(6):
        h, w = 480, 640
        img = smooth_image(rng, h, w)
        objects = []
        for _ in range(int(rng.integers(2, 5))):
            r = float(rng.uniform(30, 110))
            cx, cy = float(rng.uniform(r, w - r)), float(rng.uniform(r, h - r))
            poly = polygon(rng, cx, cy, r)
            colour = tuple(int(v) for v in rng.integers(0, 256, 3))
            cv2.fillPoly(img, [np.round(poly).astype(np.int32)], colour)
            objects.append({"category_id": int(rng.integers(1, 1204)),
                            "polygon": [round(float(v), 2) for v in poly.reshape(-1)]})
        data = encode(img, [q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        fname = f"lvis_{k:02d}.jpg"
        with open(os.path.join(args.out, fname), "wb") as f:
            f.write(data)
        rgb = cv2_rgb(data)
        entry = {"file": fname, "mode": "4:2:0, quality 90", "height": h, "width": w,
                 "sha256_rgb": hashlib.sha256(rgb.tobytes()).hexdigest(), "objects": objects}
        files.append(entry)
        images.append(fname)
    manifest = {"generator": "tools/make_jpeg_fixtures.py", "seed": args.seed,
                "libjpeg": "the cv2 build's libjpeg-turbo", "files": files,
                "lvis_images": images}
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    total = sum(os.path.getsize(os.path.join(args.out, e["file"])) for e in files)
    print(f"{len(files)} fixtures, {total} bytes -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
