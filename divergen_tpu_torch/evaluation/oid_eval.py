"""Full OpenImages (OID) challenge evaluation protocol (a copy of
``divergen_tpu/evaluation/oid_eval.py``).

From-scratch numpy implementation of the reference's
``DiverGen/divergen/evaluation/oideval.py:35-698``:

* VOC/Google-style AP (``compute_average_precision``, :35-77): monotonic
  precision envelope integrated over recall steps.
* Google-style per-image matching (``evaluate_img_google``, :289-384):
  each detection (score-sorted) greedily matches its **argmax-IoU** gt at
  IoU >= 0.5 (a gt can be detected once); *group-of* (crowd) boxes match by
  IOA >= 0.5 and contribute at most ONE true positive carrying the highest
  matched score; detections absorbed by a group-of box are removed from the
  scored list.
* Federated filtering (:187-207): detections count only for categories in
  the image's ``pos_category_ids`` ∪ ``neg_category_ids``.
* Label-hierarchy expansion (:110-149): predictions are duplicated to all
  ancestor categories from the challenge hierarchy JSON before matching
  (``expand_pred_label`` / the AP50_expand metric).
* Accumulation (:386-487): per category over all images, AP at IoU 0.5,
  mean over categories with >= 1 gt; per-class mAP vector and the
  instance-aware AP of ``_evaluate_predictions_on_oid`` (:640-698).
"""
from __future__ import annotations

import copy
import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .coco_eval_np import box_iou_xywh, mask_iou

logger = logging.getLogger(__name__)


def compute_average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-style AP (oideval.py:35-77): pad, enforce a non-increasing
    precision envelope, integrate over recall steps."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def hierarchy_ancestors(hierarchy: dict, freebase2id: Dict[str, int]) -> Dict[int, set]:
    """DFS over the challenge hierarchy JSON → {cat_id: {ancestor ids}}
    (oideval.py:117-130)."""
    fas: Dict[int, set] = defaultdict(set)

    def dfs(node, cur_id):
        all_childs = set()
        for sub in node.get("Subcategory", []):
            childs = dfs(sub, freebase2id[sub["LabelName"]])
            all_childs.update(childs)
        if cur_id != -1:
            for c in all_childs:
                fas[c].add(cur_id)
        all_childs.add(cur_id)
        return all_childs

    dfs(hierarchy, -1)
    return dict(fas)


def expand_predictions(preds: Sequence[dict], ancestors: Dict[int, set]) -> List[dict]:
    """Duplicate each prediction to its ancestor categories (:132-148)."""
    out = []
    for d in preds:
        cur = d["category_id"]
        for cat_id in [cur] + sorted(ancestors.get(cur, ())):
            nd = copy.deepcopy(d)
            nd["category_id"] = cat_id
            out.append(nd)
    return out


def _match_img_google(
    dt: List[dict], gt: List[dict], iou_type: str
):
    """Per-(image, category) Google matching (:289-384). Returns
    (scores, tp_fps, num_gt) with group-of entries appended."""
    num_gt = len(gt)
    if len(dt) == 0:
        return np.zeros((0,)), np.zeros((0,)), num_gt

    order = np.argsort([-d["score"] for d in dt], kind="mergesort")
    dt = [dt[i] for i in order]
    scores = np.array([d["score"] for d in dt], float)

    no_crowd = [i for i, g in enumerate(gt) if not g.get("iscrowd", 0)]
    crowd = [i for i, g in enumerate(gt) if g.get("iscrowd", 0)]

    if num_gt:
        iscrowd = np.array([g.get("iscrowd", 0) for g in gt], np.int32)
        if iou_type == "segm":
            full = mask_iou(dt, gt, iscrowd)
        else:
            dbox = np.array([d["bbox"] for d in dt], float).reshape(-1, 4)
            gbox = np.array([g["bbox"] for g in gt], float).reshape(-1, 4)
            full = box_iou_xywh(dbox, gbox, iscrowd)
        iou = full[:, no_crowd]
        ioa = full[:, crowd]
    else:
        iou = np.zeros((len(dt), 0))
        ioa = np.zeros((len(dt), 0))

    n = len(dt)
    tp = np.zeros(n, bool)
    matched_group_of = np.zeros(n, bool)

    if iou.shape[1] > 0:
        best = np.argmax(iou, axis=1)
        gt_detected = np.zeros(iou.shape[1], bool)
        for i in range(n):
            g = best[i]
            if not tp[i] and iou[i, g] >= 0.5 and not matched_group_of[i]:
                if not gt_detected[g]:
                    tp[i] = True
                    gt_detected[g] = True

    scores_go = np.zeros((0,), float)
    tp_go = np.zeros((0,), float)
    if ioa.shape[1] > 0:
        group_scores = np.zeros(ioa.shape[1], float)
        best = np.argmax(ioa, axis=1)
        for i in range(n):
            g = best[i]
            if not tp[i] and ioa[i, g] >= 0.5 and not matched_group_of[i]:
                matched_group_of[i] = True
                group_scores[g] = max(group_scores[g], scores[i])
        sel = group_scores > 0
        scores_go = group_scores[sel]
        tp_go = np.ones(int(sel.sum()), float)

    keep = ~matched_group_of
    out_scores = np.concatenate([scores[keep], scores_go])
    out_tpfp = np.concatenate([tp[keep].astype(float), tp_go])
    return out_scores, out_tpfp, num_gt


class OIDEval:
    """Evaluate OID AP50 over {gt dict, predictions list} in COCO layout.

    gt_data: {"images": [{id, pos_category_ids, neg_category_ids, ...}],
              "annotations": [{image_id, category_id, bbox, iscrowd|IsGroupOf,
                               segmentation?}],
              "categories": [{id, name, freebase_id?}]}
    predictions: [{image_id, category_id, bbox, score, segmentation?}]
    """

    def __init__(
        self,
        gt_data: dict,
        predictions: Sequence[dict],
        iou_type: str = "bbox",
        expand_pred_label: bool = False,
        hierarchy: Optional[dict] = None,
        max_dets: int = 1000,
    ):
        self.gt_data = gt_data
        self.iou_type = iou_type
        self.cat_ids = sorted(c["id"] for c in gt_data["categories"])
        self.img_ids = sorted(im["id"] for im in gt_data["images"])
        preds = list(predictions)
        if expand_pred_label:
            fb2id = {
                c.get("freebase_id", c["id"]): c["id"] for c in gt_data["categories"]
            }
            if hierarchy is None:
                raise ValueError("expand_pred_label requires the hierarchy JSON")
            anc = hierarchy_ancestors(hierarchy, fb2id)
            before = len(preds)
            preds = expand_predictions(preds, anc)
            logger.info("Expanded %d preds to %d via hierarchy", before, len(preds))
        # per-image cap, reference Params.max_dets=1000
        by_img: Dict[int, list] = defaultdict(list)
        for p in preds:
            by_img[p["image_id"]].append(p)
        self.predictions = []
        for img_id, plist in by_img.items():
            plist.sort(key=lambda d: -d["score"])
            self.predictions.extend(plist[:max_dets])
        self.results: Dict[str, float] = {}
        self.per_class_ap: Optional[np.ndarray] = None

    def run(self) -> Dict[str, float]:
        gts: Dict[tuple, list] = defaultdict(list)
        for a in self.gt_data["annotations"]:
            g = dict(a)
            if g.get("IsGroupOf", 0) and not g.get("iscrowd", 0):
                g["iscrowd"] = 1
            gts[a["image_id"], a["category_id"]].append(g)

        img_pos = {im["id"]: set(im.get("pos_category_ids", [])) for im in self.gt_data["images"]}
        img_neg = {im["id"]: set(im.get("neg_category_ids", [])) for im in self.gt_data["images"]}
        # reference asserts every gt category is listed in pos ids
        # (:198-200); derive them when the json doesn't carry the field
        for (img_id, cat_id) in gts:
            img_pos.setdefault(img_id, set()).add(cat_id)

        dts: Dict[tuple, list] = defaultdict(list)
        for d in self.predictions:
            img_id, cat_id = d["image_id"], d["category_id"]
            if cat_id not in img_neg.get(img_id, ()) and cat_id not in img_pos.get(img_id, ()):
                continue  # federated filter (:203-207)
            dts[img_id, cat_id].append(d)

        n_cats = len(self.cat_ids)
        precision = -np.ones((n_cats,))
        per_cat_gt = np.zeros((n_cats,), np.int64)
        for ci, cat_id in enumerate(self.cat_ids):
            all_scores, all_tpfp, num_gt = [], [], 0
            for img_id in self.img_ids:
                g = gts.get((img_id, cat_id), [])
                d = dts.get((img_id, cat_id), [])
                if not g and not d:
                    continue
                s, t, ng = _match_img_google(d, g, self.iou_type)
                all_scores.append(s)
                all_tpfp.append(t)
                num_gt += ng
            per_cat_gt[ci] = num_gt
            if num_gt == 0:
                continue
            if all_scores:
                scores = np.concatenate(all_scores)
                tpfp = np.concatenate(all_tpfp)
            else:
                scores = np.zeros((0,))
                tpfp = np.zeros((0,))
            order = np.argsort(-scores, kind="mergesort")
            tpfp = tpfp[order]
            tp_cum = np.cumsum(tpfp)
            fp_cum = np.cumsum(1.0 - tpfp)
            rc = tp_cum / num_gt
            pr = tp_cum / (tp_cum + fp_cum + np.spacing(1))
            # monotonic fixup before VOC integration (:471-473)
            pr = pr.tolist()
            for i in range(len(pr) - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            precision[ci] = compute_average_precision(
                np.array(pr, float), np.array(rc, float)
            )

        valid = precision > -1
        self.per_class_ap = precision
        self.per_cat_gt = per_cat_gt
        self.results["AP50"] = float(np.mean(precision[valid])) if valid.any() else -1.0
        # instance-aware AP (:652-668)
        sel = valid & (per_cat_gt > 0)
        if sel.any():
            self.results["AP50_instance_aware"] = float(
                np.sum(precision[sel] * per_cat_gt[sel]) / np.sum(per_cat_gt[sel])
            )
        return self.results
