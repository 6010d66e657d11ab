"""LVIS / COCO evaluator: padded device detections → records → DetEval.

Counterpart of ``divergen_tpu/evaluation/lvis_evaluator.py`` (the same
records, the same host paste in float64 through the native library; the port
has no numpy fallback there). ``process`` takes the port model's output dict,
as torch tensors on any device or as numpy arrays, and moves it to numpy once
per batch (``utils/transfer.py``). The JAX module's sources: detectron2
``evaluation/lvis_evaluation.py`` +
``divergen/evaluation/evaluator.py:106-216`` (timed inference loop) and
``per_class_map.py``. Consumes the model's static-shape outputs
(boxes/scores/classes/valid/mask_logits), back-projects boxes through the
test transform (custom_transform.py:96-114 inverse_apply_box), pastes 28²
mask logits into the original frame (detectron2 layers/mask_ops.py:74
semantics: bilinear resize into the box + 0.5 threshold) and RLE-encodes.
"""
from __future__ import annotations

import json
import logging
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

import torch

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..utils.transfer import to_host
from .coco_eval_np import DetEval

logger = logging.getLogger(__name__)


def outputs_to_numpy(outputs) -> Dict[str, np.ndarray]:
    """The model's padded output dict as numpy: torch tensors go to the host
    in one copy (``to_host``), numpy arrays pass through."""
    tensors = {k: v for k, v in outputs.items() if isinstance(v, torch.Tensor)}
    host = to_host(tensors) if tensors else {}
    return {k: host[k] if k in host else np.asarray(v) for k, v in outputs.items()}


def paste_mask_prob(mask: np.ndarray, box: np.ndarray, h: int, w: int) -> np.ndarray:
    """28² probability map → its (h, w) float64 frame before the threshold:
    ``_do_paste_mask``'s bilinear sampling (grid_sample, align_corners=False)
    over the box's sub-pixel extent, zero outside the crop and the box."""
    x1, y1, x2, y2 = [float(v) for v in box]
    x1i, y1i = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
    x2i, y2i = min(int(np.ceil(x2)), w), min(int(np.ceil(y2)), h)
    out = np.zeros((h, w))
    if x2i <= x1i or y2i <= y1i:
        return out
    mh, mw = mask.shape
    bw = max(x2 - x1, 1e-6)
    bh = max(y2 - y1, 1e-6)
    ys = (np.arange(y1i, y2i, dtype=np.float64) + 0.5 - y1) / bh * mh - 0.5
    xs = (np.arange(x1i, x2i, dtype=np.float64) + 0.5 - x1) / bw * mw - 0.5
    y0 = np.floor(ys)
    x0 = np.floor(xs)
    ly, lx = ys - y0, xs - x0
    m = mask.astype(np.float64)

    def take(yi, xi):
        ok = ((yi >= 0) & (yi < mh))[:, None] & ((xi >= 0) & (xi < mw))[None, :]
        v = m[np.clip(yi, 0, mh - 1)[:, None], np.clip(xi, 0, mw - 1)[None, :]]
        return np.where(ok, v, 0.0)

    y0i, x0i = y0.astype(np.int64), x0.astype(np.int64)
    out[y1i:y2i, x1i:x2i] = (
        take(y0i, x0i) * ((1 - ly)[:, None] * (1 - lx)[None, :])
        + take(y0i, x0i + 1) * ((1 - ly)[:, None] * lx[None, :])
        + take(y0i + 1, x0i) * (ly[:, None] * (1 - lx)[None, :])
        + take(y0i + 1, x0i + 1) * (ly[:, None] * lx[None, :])
    )
    return out


def paste_mask_np(mask: np.ndarray, box: np.ndarray, h: int, w: int) -> np.ndarray:
    """28² probability map → full-frame bool mask.

    Exact ``_do_paste_mask`` semantics (mask_ops.py: grid_sample with
    align_corners=False over the box's sub-pixel extent, zero padding,
    threshold 0.5) — a cv2.resize onto the integer box loses the fractional
    offset and shifts mask-AP measurably (tests/parity/
    test_mask_paste_parity.py pins this against the real detectron2 op).
    The plain twin of ``native.paste_mask_rle``."""
    return paste_mask_prob(mask, box, h, w) >= 0.5


class LVISEvaluator:
    """reset() / process(inputs, outputs) / evaluate() (detectron2 API)."""

    def __init__(self, dataset_name: str, tasks=("bbox", "segm"), max_dets: int = 300):
        self.dataset_name = dataset_name
        self.tasks = tasks
        self.max_dets = max_dets
        meta = MetadataCatalog.get(dataset_name)
        with open(meta.json_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda x: x["id"])
        self.contid2catid = {i: c["id"] for i, c in enumerate(cats)}
        self.freq_groups = {"r": set(), "c": set(), "f": set()}
        for c in cats:
            self.freq_groups.setdefault(c.get("frequency", "f"), set()).add(c["id"])
        self._gt_data = data
        self.reset()

    def reset(self):
        self._predictions: List[dict] = []

    def process(self, inputs: List[dict], outputs: Dict[str, np.ndarray]) -> None:
        """inputs: list of mapper sample dicts (with image_id, tfms,
        original height/width); outputs: padded detection dict (B, ...),
        torch tensors or numpy arrays."""
        from ..native import paste_mask_rle

        outputs = outputs_to_numpy(outputs)
        for b, inp in enumerate(inputs):
            valid = np.asarray(outputs["valid"][b])
            boxes = np.asarray(outputs["boxes"][b])[valid]
            scores = np.asarray(outputs["scores"][b])[valid]
            classes = np.asarray(outputs["classes"][b])[valid]
            masks = (
                np.asarray(outputs["mask_logits"][b])[valid]
                if "mask_logits" in outputs
                else None
            )
            tfms = inp.get("tfms")
            oh, ow = inp.get("orig_height"), inp.get("orig_width")
            if tfms is not None:
                boxes = tfms.inverse_apply_box(boxes)
            if oh is not None:
                boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, ow)
                boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, oh)
            for i in range(len(boxes)):
                x1, y1, x2, y2 = boxes[i]
                rec = {
                    "image_id": int(inp["image_id"]),
                    "category_id": self.contid2catid[int(classes[i])],
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(scores[i]),
                }
                if masks is not None and oh is not None:
                    prob = 1.0 / (1.0 + np.exp(-masks[i]))
                    # fused native paste + encode (native/mask_codec.cpp)
                    rec["segmentation"] = paste_mask_rle(prob, boxes[i], oh, ow)
                self._predictions.append(rec)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        data = self._gt_data
        gt_records = []
        for ann in data["annotations"]:
            rec = {
                "image_id": ann["image_id"],
                "category_id": ann["category_id"],
                "bbox": ann["bbox"],
                "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
                "iscrowd": ann.get("iscrowd", 0),
            }
            if "segmentation" in ann:
                rec["segmentation"] = self._ann_rle(ann, data)
            gt_records.append(rec)
        img_infos = {
            img["id"]: {
                "neg_category_ids": img.get("neg_category_ids", []),
                "pos_category_ids": img.get("pos_category_ids", []),
            }
            for img in data["images"]
        }
        cat_ids = [c["id"] for c in data["categories"]]
        results = {}
        for task in self.tasks:
            dets = self._predictions
            if task == "segm":
                dets = [d for d in dets if "segmentation" in d]
            ev = DetEval(
                gt_records,
                dets,
                iou_type="bbox" if task == "bbox" else "segm",
                lvis_mode=True,
                img_infos=img_infos,
                max_dets=self.max_dets,
                category_ids=cat_ids,
            )
            ev.evaluate()
            ev.accumulate()
            results[task] = ev.summarize(self.freq_groups)
            logger.info("%s %s: %s", self.dataset_name, task, results[task])
        return results

    @staticmethod
    def _ann_rle(ann: dict, data: dict) -> dict:
        from ..utils.mask_codec import polygons_to_bitmask, rle_encode

        segm = ann["segmentation"]
        if isinstance(segm, dict):
            return segm
        img = next(i for i in data["images"] if i["id"] == ann["image_id"])
        m = polygons_to_bitmask(segm, img["height"], img["width"])
        return rle_encode(m)


class CustomCOCOEvaluator(LVISEvaluator):
    """COCO-protocol variant (divergen/evaluation/custom_coco_eval.py:28):
    no federated ignore rule, 100 dets/img."""

    def __init__(self, dataset_name: str, tasks=("bbox", "segm"), max_dets: int = 100):
        super().__init__(dataset_name, tasks, max_dets)

    def evaluate(self):
        # same flow but lvis_mode off
        data = self._gt_data
        gt_records = [
            {
                "image_id": a["image_id"],
                "category_id": a["category_id"],
                "bbox": a["bbox"],
                "area": a.get("area", a["bbox"][2] * a["bbox"][3]),
                "iscrowd": a.get("iscrowd", 0),
                **(
                    {"segmentation": self._ann_rle(a, data)}
                    if "segmentation" in a
                    else {}
                ),
            }
            for a in data["annotations"]
        ]
        cat_ids = [c["id"] for c in data["categories"]]
        results = {}
        for task in self.tasks:
            dets = self._predictions
            if task == "segm":
                dets = [d for d in dets if "segmentation" in d]
            ev = DetEval(
                gt_records, dets,
                iou_type="bbox" if task == "bbox" else "segm",
                lvis_mode=False, max_dets=self.max_dets, category_ids=cat_ids,
            )
            ev.evaluate()
            ev.accumulate()
            results[task] = ev.summarize()
        return results


class LVISToCOCOEvaluator(CustomCOCOEvaluator):
    """Cross-dataset evaluation of an LVIS-trained model on COCO
    (divergen/evaluation/lvis_to_coco_evaluation.py:33-763).

    The model predicts LVIS contiguous class ids; a mapper json (the
    reference ships ``lvis_to_coco_merge_0.35_results.json``, loaded at
    :153-164) maps LVIS contiguous id → COCO dataset category id.
    Detections of unmapped LVIS categories are dropped (:191-199), then the
    standard COCO protocol runs (COCOeval semantics via DetEval: IoU
    .5:.95, 100 dets/img, per-class AP table).

    The mapper can also be synthesized by category-name matching with
    ``tools/build_lvis_to_coco_mapper`` (same synonym rule as
    ``tools/lvis_to_coco_results.py``).
    """

    def __init__(
        self,
        coco_dataset_name: str,
        mapper_json: Optional[str] = None,
        lvis_json: Optional[str] = None,
        tasks=("bbox", "segm"),
        max_dets: int = 100,
    ):
        super().__init__(coco_dataset_name, tasks, max_dets)
        if mapper_json is not None:
            with open(mapper_json) as f:
                raw = json.load(f)
            self.lvis_to_coco = {int(k): int(v) for k, v in raw.items()}
        elif lvis_json is not None:
            self.lvis_to_coco = build_lvis_to_coco_mapper(
                lvis_json, self._gt_data["categories"]
            )
        else:
            raise ValueError("provide mapper_json or lvis_json")
        # record building maps predicted (LVIS contiguous) ids straight to
        # COCO dataset category ids
        self.contid2catid = self.lvis_to_coco

    def process(self, inputs, outputs):
        outputs = outputs_to_numpy(outputs)
        classes = outputs["classes"]
        keep = np.isin(classes, np.asarray(sorted(self.lvis_to_coco.keys())))
        outputs["valid"] = np.asarray(outputs["valid"]) & keep
        super().process(inputs, outputs)


def build_lvis_to_coco_mapper(lvis_json: str, coco_categories: List[dict]) -> Dict[int, int]:
    """LVIS contiguous id → COCO dataset id by synonym/name match (the rule
    of tools/lvis_to_coco_results.py; stand-in for the reference's shipped
    merge_0.35 mapping table when it isn't available)."""
    with open(lvis_json) as f:
        lvis_cats = sorted(json.load(f)["categories"], key=lambda c: c["id"])
    coco_by_name = {c["name"].replace(" ", "_"): c["id"] for c in coco_categories}
    out: Dict[int, int] = {}
    for cont_id, c in enumerate(lvis_cats):
        for n in c.get("synonyms", [c.get("name", "")]):
            if n in coco_by_name:
                out[cont_id] = coco_by_name[n]
                break
    return out


class LVISEvaluatorWithLogits(LVISEvaluator):
    """Additionally stores each detection's full class-score vector
    (divergen/evaluation/lvis_evaluation_with_logits.py:22-380) and dumps
    them as .npz per image for analysis."""

    def __init__(self, dataset_name: str, tasks=("bbox", "segm"), max_dets: int = 300,
                 logits_dir: Optional[str] = None):
        super().__init__(dataset_name, tasks, max_dets)
        self.logits_dir = logits_dir
        self._logits: Dict[int, np.ndarray] = {}

    def process(self, inputs, outputs):
        outputs = outputs_to_numpy(outputs)
        super().process(inputs, outputs)
        if "logits" not in outputs:
            return
        import os

        for b, inp in enumerate(inputs):
            valid = np.asarray(outputs["valid"][b])
            lg = np.asarray(outputs["logits"][b])[valid]
            self._logits[int(inp["image_id"])] = lg
            if self.logits_dir:
                os.makedirs(self.logits_dir, exist_ok=True)
                np.savez_compressed(
                    os.path.join(self.logits_dir, f"{int(inp['image_id'])}.npz"), logits=lg
                )


def print_csv_format(results: Dict[str, Dict[str, float]]) -> str:
    """detectron2 print_csv_format parity: copypaste-friendly AP line."""
    lines = []
    for task, res in results.items():
        keys = ["AP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf"]
        vals = ",".join(f"{100 * res[k]:.4f}" if k in res and res[k] == res[k] else "nan" for k in keys)
        lines.append(f"copypaste: Task: {task}")
        lines.append("copypaste: " + ",".join(keys))
        lines.append("copypaste: " + vals)
    out = "\n".join(lines)
    logger.info("\n%s", out)
    return out


def per_class_ap_table(ev, class_names: Optional[List[str]] = None, cols: int = 4) -> str:
    """per-class mAP table (divergen/evaluation/per_class_map.py:10-95)."""
    pc = ev.per_category_ap()
    rows = []
    items = sorted(pc.items())
    for cid, ap in items:
        name = class_names[cid - 1] if class_names and cid - 1 < len(class_names) else str(cid)
        rows.append(f"{name}: {100 * ap:.1f}" if ap == ap else f"{name}: nan")
    lines = ["  ".join(rows[i : i + cols]) for i in range(0, len(rows), cols)]
    return "\n".join(lines)


class OIDEvaluator(LVISEvaluator):
    """OpenImages challenge metric — full reference protocol
    (divergen/evaluation/oideval.py:79-698 via evaluation/oid_eval.py):
    Google-style argmax-IoU matching at 0.5, federated pos/neg image-label
    filtering, group-of (crowd) absorption with one max-score TP per group,
    VOC AP integration, optional hierarchy expansion (AP50_expand), per-class
    mAP vector + instance-aware AP."""

    def __init__(self, dataset_name: str, tasks=("bbox",), max_dets: int = 1000,
                 output_dir: Optional[str] = None):
        super().__init__(dataset_name, tasks, max_dets)
        self.output_dir = output_dir
        meta = MetadataCatalog.get(dataset_name)
        self.hierarchy_file = getattr(meta, "hierarchy_file", None)
        self.mask_on = "segm" in tasks

    def evaluate(self):
        from .oid_eval import OIDEval

        res: Dict[str, float] = {}
        ev = OIDEval(self._gt_data, self._predictions, iou_type="bbox",
                     max_dets=self.max_dets)
        res.update(ev.run())
        if self.mask_on:
            ev_seg = OIDEval(self._gt_data, self._predictions, iou_type="segm",
                             max_dets=self.max_dets)
            res["AP50_segm"] = ev_seg.run()["AP50"]
        elif self.hierarchy_file:
            # AP50_expand: duplicate predictions to hierarchy ancestors
            # (_evaluate_predictions_on_oid, oideval.py:640-653)
            with open(self.hierarchy_file) as f:
                hierarchy = json.load(f)
            ev_x = OIDEval(
                self._gt_data, self._predictions, iou_type="bbox",
                expand_pred_label=True, hierarchy=hierarchy,
                max_dets=self.max_dets,
            )
            res["AP50_expand"] = ev_x.run()["AP50"]
        if self.output_dir:
            import os

            os.makedirs(self.output_dir, exist_ok=True)
            np.save(os.path.join(self.output_dir, "oid_mAP.npy"), ev.per_class_ap)
            with open(os.path.join(self.output_dir, "oid_instances_results.json"), "w") as f:
                json.dump(self._predictions, f)
        logger.info("%s OID results: %s", self.dataset_name, res)
        return {"bbox": res}
