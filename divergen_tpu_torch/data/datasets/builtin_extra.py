"""Extra dataset families: Objects365, OpenImages (OID), COCO zero-shot.

A copy of ``divergen_tpu/data/datasets/builtin_extra.py`` on the port's
``catalog.py`` and ``datasets/lvis.py``. Counterparts of ``DiverGen/divergen/data/datasets/objects365.py`` (771 LoC —
mostly the 365-category name table), ``oid.py``/``register_oid.py`` and
``coco_zeroshot.py`` (seen/unseen split registration). All three use
COCO-format jsons, so registration shares the LVIS loader; the name tables
load from the json's own ``categories`` (the reference hardcodes them).
"""
from __future__ import annotations

import os
from typing import Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from .lvis import load_lvis_json

# COCO 2017 → zero-shot 48 seen / 17 unseen split (coco_zeroshot.py:
# categories_seen / categories_unseen names)
COCO_SEEN_NAMES = [
    "person", "bicycle", "car", "motorcycle", "train", "truck", "boat",
    "bench", "bird", "horse", "sheep", "bear", "zebra", "giraffe",
    "backpack", "handbag", "suitcase", "frisbee", "skis", "kite",
    "surfboard", "bottle", "fork", "spoon", "bowl", "banana", "apple",
    "sandwich", "orange", "broccoli", "carrot", "pizza", "donut", "chair",
    "bed", "toilet", "tv", "laptop", "mouse", "remote", "microwave",
    "oven", "toaster", "refrigerator", "book", "clock", "vase",
    "toothbrush",
]
COCO_UNSEEN_NAMES = [
    "airplane", "bus", "cat", "dog", "cow", "elephant", "umbrella", "tie",
    "snowboard", "skateboard", "cup", "knife", "cake", "couch", "keyboard",
    "sink", "scissors",
]


def register_coco_format(name: str, json_file: str, image_root: str,
                         evaluator_type: str = "coco", **meta) -> None:
    if name in DatasetCatalog:
        return
    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type=evaluator_type, **meta
    )


def register_objects365(root: Optional[str] = None) -> None:
    """objects365.py parity: train/val splits, coco evaluator."""
    root = root or os.getenv("DETECTRON2_DATASETS", "datasets")
    for split in ("train", "val"):
        register_coco_format(
            f"objects365_{split}",
            os.path.join(root, f"objects365/annotations/objects365_{split}.json"),
            os.path.join(root, f"objects365/{split}"),
        )


def register_oid(root: Optional[str] = None) -> None:
    """oid.py / register_oid.py parity: expanded-hierarchy val split with
    the OID evaluator."""
    root = root or os.getenv("DETECTRON2_DATASETS", "datasets")
    for split, jf in (
        ("train", "oid/annotations/oid_challenge_2019_train_bbox.json"),
        ("val_expanded", "oid/annotations/oid_challenge_2019_val_expanded.json"),
    ):
        register_coco_format(
            f"oid_{split}",
            os.path.join(root, jf),
            os.path.join(root, "oid/images"),
            evaluator_type="oid",
        )


def register_coco_zeroshot(root: Optional[str] = None) -> None:
    """coco_zeroshot.py parity: 48/17 seen/unseen instance splits."""
    root = root or os.getenv("DETECTRON2_DATASETS", "datasets")
    splits = {
        "coco_zeroshot_train": "coco/zero-shot/instances_train2017_seen_2.json",
        "coco_zeroshot_val": "coco/zero-shot/instances_val2017_all_2.json",
        "coco_not_zeroshot_val": "coco/zero-shot/instances_val2017_unseen_2.json",
    }
    for name, jf in splits.items():
        register_coco_format(
            name,
            os.path.join(root, jf),
            os.path.join(root, "coco"),
            evaluator_type="coco_generalized",
            seen_names=COCO_SEEN_NAMES,
            unseen_names=COCO_UNSEEN_NAMES,
        )
