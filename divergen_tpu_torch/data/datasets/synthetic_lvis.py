"""Synthetic LVIS-format data, drawn from a seed: PNG images, jsons and an
RGBA instance pool.

For running ``do_train``, ``do_test`` and the evaluators where no LVIS data
and no instance pool is on the machine. ``write_synthetic_lvis`` writes a
set whose json has what ``lvis_v1_{train,val}.json`` have: categories with
``frequency`` r / c / f (every group used) and ``image_count``, images with
``height``, ``width``, ``not_exhaustive_category_ids`` and
``neg_category_ids``, and annotations with ``bbox`` (XYWH), ``area`` and a
``segmentation`` that is a polygon list or a compressed RLE, alternately.
Images are noise with each annotation's polygon painted in a flat colour.
``write_cat_info`` writes the category-info json that
``MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH`` names (frequency filtering, the
federated loss's weights); ``write_synthetic_pool`` an instance pool in the
layout ``INPUT.INST_POOL_PATH`` names, with the area priors of
``INPUT.AREA_PRIOR_PATH``; ``write_training_root`` all of them under a
``DETECTRON2_DATASETS`` root, where ``register_builtin`` finds the train
and val sets under their LVIS names.
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
                         category_ids: Optional[Sequence[int]] = None,
                         image_dir: str = "images", json_name: str = "annotations.json",
                         file_prefix: str = "") -> Dict[str, str]:
    """Write ``len(sizes)`` PNG images of (height, width) ``sizes`` under
    ``root/<image_dir>`` and their json at ``root/<json_name>``, each image's
    ``file_name`` prefixed with ``file_prefix``. Categories are ids
    1..num_classes with frequencies drawn from ``seed``; an annotation's
    category is drawn from ``category_ids`` if given. Returns
    ``{"json_file", "image_root"}`` for ``register_lvis_instances``."""
    rng = np.random.RandomState(seed)
    image_root = os.path.join(root, image_dir)
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
        images.append({"id": image_id, "file_name": file_prefix + file_name,
                       "height": h, "width": w,
                       "not_exhaustive_category_ids": sorted(cats)[:1],
                       "neg_category_ids": neg})
    json_file = os.path.join(root, json_name)
    os.makedirs(os.path.dirname(json_file), exist_ok=True)
    with open(json_file, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return {"json_file": json_file, "image_root": image_root}


def write_cat_info(path: str, json_file: str) -> str:
    """The category-info json of an LVIS-format ``json_file`` at ``path``:
    one ``{"id", "name", "frequency", "image_count"}`` per category, with
    the number of the json's images that hold the category (at least 1, as
    in LVIS's own file, where every category has an image)."""
    with open(json_file) as f:
        data = json.load(f)
    images_of: Dict[int, set] = {c["id"]: set() for c in data["categories"]}
    for ann in data["annotations"]:
        images_of[ann["category_id"]].add(ann["image_id"])
    info = [{"id": c["id"], "name": c["name"], "frequency": c["frequency"],
             "image_count": max(len(images_of[c["id"]]), 1)} for c in data["categories"]]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(info, f)
    return path


def _alpha(rng: np.random.RandomState, kind: int, h: int, w: int) -> np.ndarray:
    """An (h, w) uint8 alpha of one of five shapes that the largest-part cut
    has to get right: a blob with a hole and a speck beside it; two equal
    blocks (a tie); a blob with a one-pixel line leaving it; a ring with a
    component inside its hole; a blob whose edge sits on the 128 threshold."""
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.4, 0.6) * h, rng.uniform(0.4, 0.6) * w
    ry, rx = rng.uniform(0.25, 0.45) * h, rng.uniform(0.25, 0.45) * w
    ell = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
    a = np.zeros((h, w), np.uint8)
    if kind == 0:
        a[ell <= 1] = 255
        a[ell <= 0.2] = 0
        a[1:3, 1:3] = 255
    elif kind == 1:
        bh, bw = max(h // 4, 2), max(w // 4, 2)
        a[1:1 + bh, 1:1 + bw] = 255
        a[h - 1 - bh:h - 1, w - 1 - bw:w - 1] = 255
    elif kind == 2:
        a[ell <= 0.5] = 255
        a[int(cy), :] = 200
    elif kind == 3:
        a[(ell <= 1) & (ell > 0.45)] = 255
        a[ell <= 0.1] = 255
    else:
        a[ell <= 1] = 255
        a[(ell > 0.7) & (ell <= 1)] = rng.choice([100, 128, 129, 200])
    return a


def write_synthetic_pool(root: str, category_ids: Sequence[int], num_instances: int,
                         seed: int = 0, side: Tuple[int, int] = (24, 160)) -> Dict[str, str]:
    """An RGBA instance pool of ``num_instances`` entries over the 0-based
    ``category_ids`` (round robin) under ``root``: noise RGB with an alpha
    from ``_alpha``, each side drawn from ``side``. Every fifth entry is an
    ``img.png|mask.png`` pair (RGB image, gray mask) and the last one a file
    that is no PNG (the pool skips it). Writes the pool json
    ``{cat_id: [entry, ...]}`` and the area priors ``{str(cat_id + 1):
    [mean, std]}``. Returns ``{"json_file", "image_root", "area_prior"}``."""
    rng = np.random.RandomState(seed)
    image_root = os.path.join(root, "instances")
    os.makedirs(image_root, exist_ok=True)
    pool: Dict[str, List[str]] = {}
    for k in range(num_instances):
        cat = int(category_ids[k % len(category_ids)])
        h, w = (int(v) for v in rng.randint(side[0], side[1] + 1, 2))
        rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        alpha = _alpha(rng, k % 5, h, w)
        if k == num_instances - 1 and num_instances > 1:
            entry = f"{k:05d}_broken.png"
            with open(os.path.join(image_root, entry), "wb") as f:
                f.write(b"\xff\xd8\xff\xe0" + bytes(32))
        elif k % 5 == 4:
            write_png(os.path.join(image_root, f"{k:05d}_img.png"), rgb)
            write_png(os.path.join(image_root, f"{k:05d}_mask.png"), alpha)
            entry = f"{k:05d}_img.png|{k:05d}_mask.png"
        else:
            entry = f"{k:05d}.png"
            write_png(os.path.join(image_root, entry), np.concatenate([rgb, alpha[..., None]], -1))
        pool.setdefault(str(cat), []).append(entry)
    json_file = os.path.join(root, "pool.json")
    with open(json_file, "w") as f:
        json.dump(pool, f)
    prior = {str(int(c) + 1): [float(rng.uniform(0.08, 0.3)), float(rng.uniform(0.02, 0.08))]
             for c in sorted(set(int(c) for c in category_ids))}
    area_prior = os.path.join(root, "area_mean_std2.json")
    with open(area_prior, "w") as f:
        json.dump(prior, f)
    return {"json_file": json_file, "image_root": image_root, "area_prior": area_prior}


def write_training_root(root: str, num_classes: int, train_sizes: Sequence[Tuple[int, int]],
                        val_sizes: Sequence[Tuple[int, int]], pool_instances: int,
                        pool_categories: int, seed: int = 0) -> Dict[str, object]:
    """A ``DETECTRON2_DATASETS`` root for ``train_net``: the train set as
    ``lvis/lvis_v1_train.json`` over ``coco/train2017/*.png``, the val set as
    ``lvis/lvis_v1_val.json`` over ``coco/val2017/*.png`` (where
    ``register_builtin`` looks), the train set's category info under
    ``metadata/``, and a pool of ``pool_instances`` over the first
    ``pool_categories`` categories that the train set uses. Returns the
    paths and ``overrides``, the config keys (a ``merge_from_list`` list)
    that point a config at them."""
    cats = list(range(1, min(num_classes, 3 * max(pool_categories, 8)) + 1))
    train = write_synthetic_lvis(root, train_sizes, num_classes, seed=seed, category_ids=cats,
                                 image_dir="coco/train2017", json_name="lvis/lvis_v1_train.json",
                                 file_prefix="train2017/")
    val = write_synthetic_lvis(root, val_sizes, num_classes, seed=seed + 1, category_ids=cats,
                               image_dir="coco/val2017", json_name="lvis/lvis_v1_val.json",
                               file_prefix="val2017/")
    cat_info = write_cat_info(os.path.join(root, "metadata", "lvis_v1_train_cat_info.json"),
                              train["json_file"])
    pool = write_synthetic_pool(os.path.join(root, "pool"),
                                [c - 1 for c in cats[:pool_categories]], pool_instances,
                                seed=seed + 2)
    overrides = ["MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH", cat_info,
                 "INPUT.INST_POOL_PATH", pool["json_file"],
                 "INPUT.INST_POOL_ROOT", pool["image_root"],
                 "INPUT.AREA_PRIOR_PATH", pool["area_prior"],
                 "DATASETS.TRAIN", "['lvis_v1_train']",
                 "DATASETS.TEST", "['lvis_v1_val']"]
    return {"train": train, "val": val, "cat_info": cat_info, "pool": pool,
            "overrides": overrides}
