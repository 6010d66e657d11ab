"""COCO/LVIS detection evaluation core (vectorized numpy; no pycocotools).

Counterpart of ``divergen_tpu/evaluation/coco_eval_np.py``, a copy but for
the native calls: the mask IoU and the greedy matching always go through the
native library (``divergen_tpu_torch/native``, which raises if it cannot be
built); their numpy versions stay as ``mask_iou_np`` and ``greedy_match_np``,
the plain twins the tests hold the library against. Protocol notes:

- greedy per-(image, category) matching, descending score, IoU thresholds
  0.5:0.95; crowd/ignored gts can absorb otherwise-unmatched dets
- area ranges all/small/medium/large on gt area
- LVIS mode: a detection for category c on image i is *ignored* (neither TP
  nor FP) unless c ∈ pos(i) ∪ neg(i) — the federated-dataset rule; per-image
  max_dets (300) applies across categories at load time
- AP = mean over 101-point interpolated precision; LVIS averages only over
  categories with ≥1 gt; APr/APc/APf split by the frequency table
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix (D, G) on XYWH boxes; crowd gt → intersection/det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.maximum(
        0, np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None])
    )
    iy = np.maximum(
        0, np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None])
    )
    inter = ix * iy
    da = (dets[:, 2] * dets[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None], da, da + ga - inter)
    return inter / np.maximum(union, 1e-9)


def mask_iou(dets: List[Dict], gts: List[Dict], iscrowd: np.ndarray) -> np.ndarray:
    """IoU on RLE masks by the native run-merge kernel."""
    from ..native import rle_iou_matrix

    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    return rle_iou_matrix(dets, gts, iscrowd)


def mask_iou_np(dets: List[Dict], gts: List[Dict], iscrowd: np.ndarray) -> np.ndarray:
    """``mask_iou`` on decoded masks: the plain twin of the native kernel."""
    from ..utils.mask_codec import rle_decode

    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dm = [rle_decode(r).reshape(-1) for r in dets]
    gm = [rle_decode(r).reshape(-1) for r in gts]
    out = np.zeros((len(dm), len(gm)))
    for j, g in enumerate(gm):
        gs = g.sum()
        for i, d in enumerate(dm):
            inter = np.logical_and(d, g).sum()
            union = d.sum() if iscrowd[j] else d.sum() + gs - inter
            out[i, j] = inter / max(union, 1e-9)
    return out


def greedy_match_np(ious: np.ndarray, g_ignore: np.ndarray, iscrowd: np.ndarray,
                    thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy COCO matching in numpy, the plain twin of ``native.greedy_match``:
    (T, D) matched gt index + 1 (0: unmatched) and ignore flags."""
    D, G = ious.shape
    T = len(thrs)
    dt_matched = np.zeros((T, D), np.int64)
    dt_ignore = np.zeros((T, D), bool)
    gt_matched = np.zeros((T, G), bool)
    for t, thr in enumerate(thrs):
        for di in range(D):
            best = -1
            best_iou = min(thr, 1 - 1e-10)
            for gi in range(G):
                if gt_matched[t, gi] and not iscrowd[gi]:
                    continue
                # dets matched to real gts can't downgrade to ignored
                if best > -1 and not g_ignore[best] and g_ignore[gi]:
                    break
                if ious[di, gi] >= best_iou:
                    best_iou = ious[di, gi]
                    best = gi
            if best > -1:
                dt_matched[t, di] = best + 1
                dt_ignore[t, di] = g_ignore[best]
                gt_matched[t, best] = True
    return dt_matched, dt_ignore


class DetEval:
    """evaluate() + accumulate() + summarize() over plain dict records.

    gt records:  {image_id, category_id, bbox(xywh), area, iscrowd,
                  segmentation(optional RLE), ignore(optional)}
    det records: {image_id, category_id, bbox(xywh), score,
                  segmentation(optional RLE)}
    img_infos:   {image_id: {"neg_category_ids": [...], "pos_category_ids":
                  [...]}} — only consulted in lvis mode.
    """

    def __init__(
        self,
        gt_records: Sequence[dict],
        det_records: Sequence[dict],
        iou_type: str = "bbox",
        lvis_mode: bool = False,
        img_infos: Optional[Dict] = None,
        max_dets: int = 300,
        category_ids: Optional[Sequence[int]] = None,
        iou_thrs: Optional[np.ndarray] = None,
    ):
        self.iou_thrs = np.asarray(iou_thrs) if iou_thrs is not None else IOU_THRS
        self.iou_type = iou_type
        self.lvis = lvis_mode
        self.max_dets = max_dets
        self.img_infos = img_infos or {}

        if lvis_mode:
            det_records = self._cap_per_image(det_records, max_dets)

        self.gts = defaultdict(list)
        self.dets = defaultdict(list)
        img_ids = set()
        cat_ids = set(category_ids or [])
        for g in gt_records:
            self.gts[(g["image_id"], g["category_id"])].append(g)
            img_ids.add(g["image_id"])
            if category_ids is None:
                cat_ids.add(g["category_id"])
        for d in det_records:
            self.dets[(d["image_id"], d["category_id"])].append(d)
            img_ids.add(d["image_id"])
        if self.img_infos:
            img_ids |= set(self.img_infos)
        self.img_ids = sorted(img_ids)
        self.cat_ids = sorted(cat_ids)
        self._eval_imgs: Dict = {}

    @staticmethod
    def _cap_per_image(dets: Sequence[dict], max_dets: int) -> List[dict]:
        by_img = defaultdict(list)
        for d in dets:
            by_img[d["image_id"]].append(d)
        out = []
        for recs in by_img.values():
            recs.sort(key=lambda r: -r["score"])
            out += recs[:max_dets]
        return out

    # ---------------- evaluate ----------------
    def _eval_img_cat(self, img_id, cat_id, area_rng) -> Optional[dict]:
        gts = self.gts.get((img_id, cat_id), [])
        dets = self.dets.get((img_id, cat_id), [])
        if self.lvis:
            info = self.img_infos.get(img_id, {})
            neg = set(info.get("neg_category_ids", []))
            pos = set(info.get("pos_category_ids", [])) or {
                c for (i, c) in self.gts if i == img_id
            }
            if cat_id not in pos and cat_id not in neg:
                return None  # category unverified on this image → skip
        if not gts and not dets:
            return None
        dets = sorted(dets, key=lambda d: -d["score"])[: self.max_dets]
        lo, hi = area_rng
        g_ignore = np.array(
            [
                bool(g.get("ignore", 0))
                or bool(g.get("iscrowd", 0))
                or not (lo <= g.get("area", g["bbox"][2] * g["bbox"][3]) < hi)
                for g in gts
            ],
            dtype=bool,
        )
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], dtype=bool)
        # sort gts: real first, ignored last (COCO protocol)
        order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in order]
        g_ignore = g_ignore[order]
        iscrowd = iscrowd[order]

        if self.iou_type == "segm":
            ious = mask_iou(
                [d["segmentation"] for d in dets], [g["segmentation"] for g in gts], iscrowd
            )
        else:
            ious = box_iou_xywh(
                np.array([d["bbox"] for d in dets], np.float64).reshape(-1, 4),
                np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
                iscrowd,
            )

        T, D, G = len(self.iou_thrs), len(dets), len(gts)
        if D and G:
            from ..native import greedy_match

            dt_matched, dt_ignore = greedy_match(ious, g_ignore, iscrowd, self.iou_thrs)
        else:
            dt_matched = np.zeros((T, D), np.int64)  # 0 = unmatched, else gt idx+1
            dt_ignore = np.zeros((T, D), bool)
        # unmatched dets outside the area range are ignored
        d_areas = np.array(
            [d["bbox"][2] * d["bbox"][3] for d in dets], np.float64
        )
        out_of_rng = (d_areas < lo) | (d_areas >= hi)
        dt_ignore |= (dt_matched == 0) & out_of_rng[None]
        return {
            "scores": np.array([d["score"] for d in dets]),
            "dt_matched": dt_matched,
            "dt_ignore": dt_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    def evaluate(self) -> None:
        for cat in self.cat_ids:
            for aname, arng in AREA_RANGES.items():
                for img in self.img_ids:
                    r = self._eval_img_cat(img, cat, arng)
                    if r is not None:
                        self._eval_imgs[(cat, aname, img)] = r

    # ---------------- accumulate ----------------
    def accumulate(self) -> Dict[str, np.ndarray]:
        T, R = len(self.iou_thrs), len(REC_THRS)
        K = len(self.cat_ids)
        A = len(AREA_RANGES)
        precision = -np.ones((T, R, K, A))
        recall = -np.ones((T, K, A))
        self.num_gt_per_cat = np.zeros(K, np.int64)
        for k, cat in enumerate(self.cat_ids):
            for a, aname in enumerate(AREA_RANGES):
                rs = [
                    self._eval_imgs[(cat, aname, img)]
                    for img in self.img_ids
                    if (cat, aname, img) in self._eval_imgs
                ]
                if not rs:
                    continue
                scores = np.concatenate([r["scores"] for r in rs])
                order = np.argsort(-scores, kind="mergesort")
                matched = np.concatenate([r["dt_matched"] for r in rs], axis=1)[:, order]
                ignored = np.concatenate([r["dt_ignore"] for r in rs], axis=1)[:, order]
                num_gt = sum(r["num_gt"] for r in rs)
                if aname == "all" and num_gt > 0:
                    self.num_gt_per_cat[k] = num_gt
                if num_gt == 0:
                    continue
                tp = (matched > 0) & ~ignored
                fp = (matched == 0) & ~ignored
                tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
                fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
                for t in range(T):
                    rc = tp_cum[t] / num_gt
                    pr = tp_cum[t] / np.maximum(tp_cum[t] + fp_cum[t], 1e-9)
                    recall[t, k, a] = rc[-1] if len(rc) else 0.0
                    # monotone envelope
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    idxs = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(R)
                    ok = idxs < len(pr)
                    q[ok] = pr[idxs[ok]]
                    precision[t, :, k, a] = q
        self.precision = precision
        self.recall = recall
        return {"precision": precision, "recall": recall}

    # ---------------- summarize ----------------
    def summarize(self, freq_groups: Optional[Dict[str, set]] = None) -> Dict[str, float]:
        res: Dict[str, float] = {}
        area_names = list(AREA_RANGES)

        def ap(t_slice=slice(None), cat_mask=None, area="all"):
            a = area_names.index(area)
            p = self.precision[t_slice, :, :, a]
            if cat_mask is not None:
                p = p[:, :, cat_mask]
            p = p[p > -1]
            return float(p.mean()) if p.size else float("nan")

        res["AP"] = ap()
        res["AP50"] = ap(t_slice=slice(0, 1))
        res["AP75"] = (
            ap(t_slice=slice(5, 6)) if len(self.iou_thrs) > 5 else float("nan")
        )
        res["APs"] = ap(area="small")
        res["APm"] = ap(area="medium")
        res["APl"] = ap(area="large")
        if freq_groups:
            for key, name in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                mask = np.array([c in freq_groups.get(key, set()) for c in self.cat_ids])
                res[name] = ap(cat_mask=mask) if mask.any() else float("nan")
        return res

    def per_category_ap(self) -> Dict[int, float]:
        """per-class mAP table (divergen/evaluation/per_class_map.py:10-95)."""
        a = list(AREA_RANGES).index("all")
        out = {}
        for k, cat in enumerate(self.cat_ids):
            p = self.precision[:, :, k, a]
            p = p[p > -1]
            out[cat] = float(p.mean()) if p.size else float("nan")
        return out
