"""LVIS v1 dataset registration (no lvis-api dependency; a copy of
``divergen_tpu/data/datasets/lvis.py``).

Counterpart of ``DiverGen/divergen/data/datasets/lvis_v1.py:16-136``
(``custom_register_lvis_instances`` / ``custom_load_lvis_json``: file_name
fix from coco_url, 0-based pos/neg category ids, polygon validation) and of
the rare/common/frequent id tables BSGAL imports from the missing
``tools/lvis_my`` module (SURVEY.md §2.2 ⚠ — here derived from the
category ``frequency`` field, which is what that module encoded).
"""
from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)


def load_lvis_json(
    json_file: str, image_root: str, dataset_name: Optional[str] = None,
    keep_ann_ids: bool = False,
) -> List[dict]:
    """LVIS/COCO-format json → list of per-image records.

    ``keep_ann_ids`` mirrors BSGAL's ``load_lvis_json_with_id``
    (BSGAL/bsgal/modeling/utils.py:64-120).
    """
    with open(json_file) as f:
        data = json.load(f)

    cats = sorted(data["categories"], key=lambda x: x["id"])
    catid2contid = {c["id"]: i for i, c in enumerate(cats)}
    if len(cats) == 1203:
        assert all(catid2contid[c["id"]] == c["id"] - 1 for c in cats)

    anns_by_img: Dict[int, List[dict]] = defaultdict(list)
    for ann in data["annotations"]:
        anns_by_img[ann["image_id"]].append(ann)

    ann_ids = [a["id"] for a in data["annotations"]]
    assert len(set(ann_ids)) == len(ann_ids), f"duplicate annotation ids in {json_file}"

    records = []
    for img in sorted(data["images"], key=lambda x: x["id"]):
        rec: dict = {}
        if "file_name" in img:
            fn = img["file_name"]
            if fn.startswith("COCO"):  # 2014-style names
                fn = fn[-16:]
            rec["file_name"] = os.path.join(image_root, fn)
        elif "coco_url" in img:
            # http://images.cocodataset.org/train2017/xxx.jpg → train2017/xxx.jpg
            rec["file_name"] = os.path.join(image_root, img["coco_url"][30:])
        if "height" in img:
            rec["height"] = img["height"]
        if "width" in img:
            rec["width"] = img["width"]
        rec["not_exhaustive_category_ids"] = img.get("not_exhaustive_category_ids", [])
        rec["neg_category_ids"] = [
            catid2contid[x] for x in img.get("neg_category_ids", [])
        ]
        if "pos_category_ids" in img:
            rec["pos_category_ids"] = [catid2contid[x] for x in img["pos_category_ids"]]
        rec["image_id"] = img["id"]

        objs = []
        for ann in anns_by_img.get(img["id"], []):
            if ann.get("iscrowd", 0) > 0:
                continue
            obj = {
                "bbox": ann["bbox"],  # XYWH_ABS
                "category_id": catid2contid[ann["category_id"]],
            }
            if keep_ann_ids:
                obj["ann_id"] = ann["id"]
            if "segmentation" in ann:
                segm = ann["segmentation"]
                if isinstance(segm, list):
                    valid = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                    if len(valid) != len(segm):
                        logger.warning("invalid polygon (<3 points) in ann %s", ann.get("id"))
                    assert len(segm) > 0
                obj["segmentation"] = segm
            objs.append(obj)
        rec["annotations"] = objs
        records.append(rec)
    logger.info("loaded %d images from %s", len(records), json_file)
    return records


def frequency_groups(cat_info: List[dict]) -> Dict[str, Set[int]]:
    """0-based contiguous-id sets per frequency bucket — the replacement for
    the missing ``lvis_my.lvis_categories_tr`` RARE_ID_SET etc."""
    groups: Dict[str, Set[int]] = {"r": set(), "c": set(), "f": set()}
    for info in sorted(cat_info, key=lambda x: x["id"]):
        groups[info["frequency"]].add(info["id"] - 1)
    return groups


def lvis_meta_from_json(json_file: str) -> dict:
    with open(json_file) as f:
        cats = sorted(json.load(f)["categories"], key=lambda x: x["id"])
    return {
        "thing_classes": [c.get("synonyms", [c.get("name", str(c["id"]))])[0] for c in cats],
        "class_image_count": [
            {"id": c["id"], "image_count": c.get("image_count", 0)} for c in cats
        ],
        "frequencies": [c.get("frequency", "f") for c in cats],
    }


def register_lvis_instances(name: str, metadata: dict, json_file: str, image_root: str,
                            keep_ann_ids: bool = False) -> None:
    DatasetCatalog.register(
        name, lambda: load_lvis_json(json_file, image_root, name, keep_ann_ids)
    )
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="lvis", **metadata
    )


def register_synthetic_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Synthetic-pool datasets (divergen/data/datasets/syn4det.py:8-35) share
    the LVIS loading path; evaluator stays lvis."""
    register_lvis_instances(name, metadata, json_file, image_root)


def register_builtin(root: Optional[str] = None) -> None:
    """Standard splits, lazily pointing into $DETECTRON2_DATASETS."""
    root = root or os.getenv("DETECTRON2_DATASETS", "datasets")
    splits = {
        "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
        "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
        "lvis_v1_train_norare": ("coco/", "lvis/lvis_v1_train_norare.json"),
    }
    for key, (image_root, json_file) in splits.items():
        if key in DatasetCatalog:
            continue
        jf = os.path.join(root, json_file)
        DatasetCatalog.register(
            key, (lambda jf=jf, ir=os.path.join(root, image_root), k=key: load_lvis_json(jf, ir, k))
        )
        MetadataCatalog.get(key).set(
            json_file=jf, image_root=os.path.join(root, image_root), evaluator_type="lvis"
        )
