"""Native Cityscapes instance-level AP scoring (no ``cityscapesscripts``).

A copy of ``divergen_tpu/evaluation/cityscapes_instance_scoring.py`` (its
docstring states the protocol): ``InstanceScorer`` and the label tables are
the same code line for line (``tests/test_torch_port_weights.py`` holds
them), and ``score_prediction_dir`` reads the ``*_instanceIds.png`` ground
truth (16-bit gray) and the prediction masks through ``utils/png.py``
instead of PIL. Two behaviours are kept as they are: a ground-truth image
without a ``*_pred.txt`` scores as zero predictions, and a directory without
``*_instanceIds.png`` raises ``FileNotFoundError``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# (name, id, hasInstances, ignoreInEval) — the full 34-label table
CITYSCAPES_LABELS: List[Tuple[str, int, bool, bool]] = [
    ("unlabeled", 0, False, True),
    ("ego vehicle", 1, False, True),
    ("rectification border", 2, False, True),
    ("out of roi", 3, False, True),
    ("static", 4, False, True),
    ("dynamic", 5, False, True),
    ("ground", 6, False, True),
    ("road", 7, False, False),
    ("sidewalk", 8, False, False),
    ("parking", 9, False, True),
    ("rail track", 10, False, True),
    ("building", 11, False, False),
    ("wall", 12, False, False),
    ("fence", 13, False, False),
    ("guard rail", 14, False, True),
    ("bridge", 15, False, True),
    ("tunnel", 16, False, True),
    ("pole", 17, False, False),
    ("polegroup", 18, False, True),
    ("traffic light", 19, False, False),
    ("traffic sign", 20, False, False),
    ("vegetation", 21, False, False),
    ("terrain", 22, False, False),
    ("sky", 23, False, False),
    ("person", 24, True, False),
    ("rider", 25, True, False),
    ("car", 26, True, False),
    ("truck", 27, True, False),
    ("bus", 28, True, False),
    ("caravan", 29, True, True),
    ("trailer", 30, True, True),
    ("train", 31, True, False),
    ("motorcycle", 32, True, False),
    ("bicycle", 33, True, False),
]

EVAL_INSTANCE_IDS: Tuple[int, ...] = tuple(
    lid for _, lid, has_inst, ignore in CITYSCAPES_LABELS if has_inst and not ignore
)
VOID_IDS: Tuple[int, ...] = tuple(
    lid for _, lid, _, ignore in CITYSCAPES_LABELS if ignore
)
ID_TO_NAME = {lid: name for name, lid, _, _ in CITYSCAPES_LABELS}

DEFAULT_OVERLAPS = np.arange(0.5, 1.0, 0.05)
MIN_REGION_SIZE = 100  # pixels, the cityscapes default for gtFine


@dataclass
class _ImageEval:
    """Per-image, per-class intermediate: everything matching needs."""

    # per gt instance: pixel count
    gt_sizes: np.ndarray
    # per (pred, gt): intersection pixel counts
    inter: np.ndarray
    # per pred: pixel count, confidence, ignored-pixel count (void +
    # same-class crowd + same-class under-min-size gt)
    pred_sizes: np.ndarray
    pred_conf: np.ndarray
    pred_ignore: np.ndarray


@dataclass
class InstanceScorer:
    """Accumulate images, then :meth:`summarize`.

    ``eval_ids`` defaults to the 8 standard thing classes; pass a subset to
    score partial-vocabulary dumps (e.g. LVIS-mapped predictions).
    """

    overlaps: np.ndarray = field(default_factory=lambda: DEFAULT_OVERLAPS.copy())
    min_region_size: int = MIN_REGION_SIZE
    eval_ids: Sequence[int] = EVAL_INSTANCE_IDS
    _per_class: Dict[int, List[_ImageEval]] = field(default_factory=dict)

    def add_image(
        self,
        gt_instance_map: np.ndarray,
        preds: Sequence[Tuple[np.ndarray, int, float]],
    ) -> None:
        """``gt_instance_map``: (H, W) int array in instanceIds.png encoding.
        ``preds``: (bool mask (H, W), cityscapes label_id, confidence)."""
        gt = np.asarray(gt_instance_map)
        label_of_pixel = np.where(gt >= 1000, gt // 1000, gt)
        void_mask = np.isin(label_of_pixel, VOID_IDS)
        for cls in self.eval_ids:
            cls_preds = [
                (np.asarray(m, bool), float(c))
                for m, lid, c in preds
                if int(lid) == cls
            ]
            # real instances of this class
            ids = np.unique(gt[(label_of_pixel == cls) & (gt >= 1000)])
            inst_masks = [gt == i for i in ids]
            sizes = np.array([int(m.sum()) for m in inst_masks], np.int64)
            big = sizes >= self.min_region_size
            crowd_mask = (gt == cls)  # group/crowd region: bare label id
            # too-small instances are treated like crowd: ignored, and
            # they shield overlapping predictions from counting as FPs
            small_union = np.zeros_like(void_mask)
            for m, keep in zip(inst_masks, big):
                if not keep:
                    small_union |= m
            kept_masks = [m for m, keep in zip(inst_masks, big) if keep]
            ignore_region = void_mask | crowd_mask | small_union

            if not cls_preds and not kept_masks:
                continue
            inter = np.zeros((len(cls_preds), len(kept_masks)), np.int64)
            p_sizes = np.zeros(len(cls_preds), np.int64)
            p_conf = np.zeros(len(cls_preds), np.float64)
            p_ign = np.zeros(len(cls_preds), np.int64)
            for pi, (pm, conf) in enumerate(cls_preds):
                p_sizes[pi] = int(pm.sum())
                p_conf[pi] = conf
                p_ign[pi] = int((pm & ignore_region).sum())
                for gi, gm in enumerate(kept_masks):
                    inter[pi, gi] = int((pm & gm).sum())
            self._per_class.setdefault(cls, []).append(
                _ImageEval(sizes[big], inter, p_sizes, p_conf, p_ign)
            )

    def _class_ap(self, images: List[_ImageEval], overlap: float) -> Optional[float]:
        """AP for one class at one overlap threshold; None when the class
        has no GT anywhere (excluded from the average, cityscapes rule)."""
        y_true: List[int] = []
        y_score: List[float] = []
        n_gt = 0  # unmatched GT count only here (hard FNs): recall denominator
        for im in images:
            n_gt += len(im.gt_sizes)
            matched = np.zeros(len(im.gt_sizes), bool)
            best = np.full(len(im.gt_sizes), -np.inf)
            for pi in range(len(im.pred_sizes)):
                found = False
                for gi in range(len(im.gt_sizes)):
                    union = im.gt_sizes[gi] + im.pred_sizes[pi] - im.inter[pi, gi]
                    iou = im.inter[pi, gi] / union if union > 0 else 0.0
                    if iou > overlap:
                        found = True
                        conf = im.pred_conf[pi]
                        if matched[gi]:
                            # second match on the same gt: the lower-scored
                            # of the two becomes an FP
                            lo, hi = sorted((best[gi], conf))
                            best[gi] = hi
                            y_true.append(0)
                            y_score.append(lo)
                        else:
                            matched[gi] = True
                            best[gi] = conf
                if not found:
                    frac = im.pred_ignore[pi] / im.pred_sizes[pi] if im.pred_sizes[pi] else 1.0
                    if frac <= overlap:
                        y_true.append(0)
                        y_score.append(im.pred_conf[pi])
            for gi in range(len(im.gt_sizes)):
                if matched[gi]:
                    y_true.append(1)
                    y_score.append(best[gi])
        if n_gt == 0:
            return None
        if not y_true:
            return 0.0
        yt = np.asarray(y_true)
        ys = np.asarray(y_score)
        # precision/recall at each distinct confidence threshold
        order = np.argsort(-ys)
        yt, ys = yt[order], ys[order]
        distinct = np.r_[np.nonzero(np.diff(ys))[0], len(ys) - 1]
        tp = np.cumsum(yt)[distinct].astype(np.float64)
        fp = np.cumsum(1 - yt)[distinct].astype(np.float64)
        prec = tp / np.maximum(tp + fp, 1)
        rec = tp / n_gt  # denominator includes the hard FNs
        # cityscapes integration: only the (p=1, r=0) artificial start point,
        # trapezoid over the ACHIEVED recall range — unreached recall
        # contributes nothing (an extra (p=0, r=1) endpoint would add a
        # phantom (1-r_max)*p_last/2 area and inflate AP whenever any GT
        # instance is missed)
        prec = np.r_[1.0, prec]
        rec = np.r_[0.0, rec]
        return float(np.sum(np.diff(rec) * (prec[1:] + prec[:-1]) / 2.0))

    def summarize(self) -> Dict[str, object]:
        per_class: Dict[str, Dict[str, float]] = {}
        for cls in self.eval_ids:
            images = self._per_class.get(cls, [])
            aps = {float(o): self._class_ap(images, float(o)) for o in self.overlaps}
            if all(v is None for v in aps.values()):
                continue  # no GT of this class anywhere
            vals = [v for v in aps.values() if v is not None]
            per_class[ID_TO_NAME[cls]] = {
                "ap": float(np.mean(vals)),
                "ap50%": aps[0.5] if aps[0.5] is not None else float("nan"),
            }
        all_ap = float(np.mean([c["ap"] for c in per_class.values()])) if per_class else float("nan")
        all_ap50 = (
            float(np.mean([c["ap50%"] for c in per_class.values()])) if per_class else float("nan")
        )
        return {"allAp": all_ap, "allAp50%": all_ap50, "classes": per_class}


def score_prediction_dir(
    pred_dir: str,
    gt_dir: str,
    eval_ids: Sequence[int] = EVAL_INSTANCE_IDS,
) -> Dict[str, object]:
    """Score a cityscapes-format dump (``*_pred.txt`` + mask PNGs, the
    layout ``LVISToCityscapesInstanceEvaluator.process`` writes and
    ``cityscapesscripts`` consumes) against ``*_instanceIds.png`` GT found
    under ``gt_dir`` (searched recursively, city subdirs included)."""
    import glob

    from ..utils.png import read_png

    gt_list = sorted(
        glob.glob(os.path.join(gt_dir, "**", "*_instanceIds.png"), recursive=True)
    )
    if not gt_list:
        raise FileNotFoundError(f"no *_instanceIds.png under {gt_dir!r}")
    scorer = InstanceScorer(eval_ids=eval_ids)
    for gt_png in gt_list:
        base = os.path.basename(gt_png)
        for suffix in ("_gtFine_instanceIds.png", "_instanceIds.png"):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
                break
        gt_map = np.asarray(read_png(gt_png), np.int64)
        preds = []
        # dumps name files after the input image (often *_leftImg8bit)
        cands = [
            os.path.join(pred_dir, base + "_pred.txt"),
            os.path.join(pred_dir, base + "_leftImg8bit_pred.txt"),
        ]
        txt = next((c for c in cands if os.path.exists(c)), cands[0])
        if os.path.exists(txt):
            with open(txt) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 3:
                        continue
                    png, label_id, conf = parts
                    mask = read_png(os.path.join(pred_dir, png)) > 0
                    preds.append((mask, int(label_id), float(conf)))
        scorer.add_image(gt_map, preds)
    return scorer.summarize()
