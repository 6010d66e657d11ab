"""A synthetic LVIS-format test set, drawn from a seed: PNG images and a json.

For running ``do_test`` and the evaluators where no LVIS data is on the
machine. The json has what ``lvis_v1_val.json`` has for evaluation:
categories with ``frequency`` r / c / f (every group used), images with
``height``, ``width``, ``not_exhaustive_category_ids`` and
``neg_category_ids``, and annotations with ``bbox`` (XYWH), ``area`` and a
``segmentation`` that is a polygon list or a compressed RLE, alternately.
Images are noise with each annotation's polygon painted in a flat colour.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...utils.mask_codec import polygons_to_bitmask, rle_encode
from ...utils.png import write_png


def _polygon(rng: np.random.RandomState, h: int, w: int) -> List[float]:
    """A star-shaped polygon inside an (h, w) frame."""
    cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
    radius = rng.uniform(0.08, 0.3) * min(h, w)
    n = rng.randint(5, 11)
    ang = np.sort(rng.rand(n)) * 2 * np.pi
    r = radius * rng.uniform(0.6, 1.0, n)
    x = np.clip(cx + r * np.cos(ang), 0, w - 1)
    y = np.clip(cy + r * np.sin(ang), 0, h - 1)
    return np.round(np.stack([x, y], 1), 2).reshape(-1).tolist()


def write_synthetic_lvis(root: str, sizes: Sequence[Tuple[int, int]], num_classes: int,
                         seed: int = 0, anns_per_image: Tuple[int, int] = (2, 5),
                         category_ids: Optional[Sequence[int]] = None) -> Dict[str, str]:
    """Write ``len(sizes)`` PNG images of (height, width) ``sizes`` under
    ``root/images`` and their json at ``root/annotations.json``. Categories
    are ids 1..num_classes with frequencies drawn from ``seed``; an
    annotation's category is drawn from ``category_ids`` if given. Returns
    ``{"json_file", "image_root"}`` for ``register_lvis_instances``."""
    rng = np.random.RandomState(seed)
    image_root = os.path.join(root, "images")
    os.makedirs(image_root, exist_ok=True)
    freq = rng.choice(["r", "c", "f"], num_classes, p=[0.3, 0.4, 0.3])
    freq[:3] = ["r", "c", "f"]  # every group present
    categories = [{"id": i + 1, "name": f"class_{i + 1}", "synonyms": [f"class_{i + 1}"],
                   "frequency": str(freq[i]), "image_count": int(rng.randint(1, 100))}
                  for i in range(num_classes)]
    pool = np.asarray(category_ids if category_ids is not None else np.arange(1, num_classes + 1))
    images, annotations = [], []
    for k, (h, w) in enumerate(sizes):
        image_id = k + 1
        pixels = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        cats = set()
        for j in range(rng.randint(anns_per_image[0], anns_per_image[1] + 1)):
            cat = int(pool[(k + j) % len(pool)] if j == 0 else rng.choice(pool))
            poly = _polygon(rng, h, w)
            mask = polygons_to_bitmask([poly], h, w)
            pixels[mask] = rng.randint(0, 256, 3)
            ys, xs = np.nonzero(mask)
            bbox = [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                    float(ys.max() - ys.min() + 1)]
            if len(annotations) % 2:
                rle = rle_encode(mask)
                segm = {"size": rle["size"], "counts": rle["counts"].decode()}
            else:
                segm = [poly]
            annotations.append({"id": len(annotations) + 1, "image_id": image_id,
                                "category_id": cat, "bbox": bbox, "area": float(mask.sum()),
                                "segmentation": segm, "iscrowd": 0})
            cats.add(cat)
        others = [c for c in range(1, num_classes + 1) if c not in cats]
        neg = sorted(int(c) for c in rng.choice(others, min(3, len(others)), replace=False))
        file_name = f"{image_id:012d}.png"
        write_png(os.path.join(image_root, file_name), pixels)
        images.append({"id": image_id, "file_name": file_name, "height": h, "width": w,
                       "not_exhaustive_category_ids": sorted(cats)[:1],
                       "neg_category_ids": neg})
    json_file = os.path.join(root, "annotations.json")
    with open(json_file, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return {"json_file": json_file, "image_root": image_root}
