"""CenterNet2 proposal generator (torch): head, ground truth, losses, decoding.

Counterpart of ``divergen_tpu/modeling/centernet/centernet.py``:
``CenterNetConfig``, ``CenterNetHead`` (conv towers shared over the levels
with a per-level ``Scale``), ``level_geometry``, ``centernet_ground_truth``,
``centernet_losses`` and ``centernet_proposals`` over a flattened level axis
M = Σ_l H_l·W_l with static shapes; and for the standalone detector
(``only_proposal=False``) the classwise head, ``centernet_ground_truth_classwise``,
``centernet_losses_classwise`` and ``centernet_detections`` (class-aware NMS).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.losses import heatmap_focal_loss, iou_loss
from ...ops.nms import batched_nms_mask, nms_mask, stable_topk, top_scoring
from ..layers import ConvNorm, Scale


@dataclasses.dataclass(frozen=True)
class CenterNetConfig:
    in_features: Tuple[str, ...] = ("p3", "p4", "p5", "p6", "p7")
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    sizes_of_interest: Tuple[Tuple[float, float], ...] = (
        (0, 80), (64, 160), (128, 320), (256, 640), (512, 10000000))
    hm_min_overlap: float = 0.8
    min_radius: float = 4.0
    score_thresh: float = 0.05
    hm_focal_alpha: float = 0.25
    hm_focal_beta: float = 4.0
    loss_gamma: float = 2.0
    pos_weight: float = 0.5
    neg_weight: float = 0.5
    reg_weight: float = 1.0
    not_norm_reg: bool = True
    sigmoid_clamp: float = 1e-4
    ignore_high_fp: float = 0.85
    loc_loss_type: str = "giou"
    pre_nms_topk_train: int = 1000
    post_nms_topk_train: int = 100
    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 100
    nms_thresh_train: float = 0.6
    nms_thresh_test: float = 0.6
    # total candidates kept (by score) across levels before the single
    # cross-level NMS
    pre_nms_total: int = 4000
    num_cls_convs: int = 4
    num_box_convs: int = 4
    num_share_convs: int = 0
    norm: str = "GN"
    prior_prob: float = 0.01
    only_proposal: bool = True
    with_agn_hm: bool = True
    num_classes: int = 80  # classwise head when not only_proposal

    @property
    def delta(self) -> float:
        return (1 - self.hm_min_overlap) / (1 + self.hm_min_overlap)

    @staticmethod
    def from_cfg(cfg) -> "CenterNetConfig":
        cn = cfg.MODEL.CENTERNET
        return CenterNetConfig(
            in_features=tuple(cn.IN_FEATURES),
            strides=tuple(cn.FPN_STRIDES),
            sizes_of_interest=tuple(tuple(s) for s in cn.SOI),
            hm_min_overlap=cn.HM_MIN_OVERLAP,
            min_radius=cn.MIN_RADIUS,
            score_thresh=cn.INFERENCE_TH,
            hm_focal_alpha=cn.HM_FOCAL_ALPHA,
            hm_focal_beta=cn.HM_FOCAL_BETA,
            loss_gamma=cn.LOSS_GAMMA,
            pos_weight=cn.POS_WEIGHT,
            neg_weight=cn.NEG_WEIGHT,
            reg_weight=cn.REG_WEIGHT,
            not_norm_reg=cn.NOT_NORM_REG,
            sigmoid_clamp=cn.SIGMOID_CLAMP,
            ignore_high_fp=cn.IGNORE_HIGH_FP,
            loc_loss_type=cn.LOC_LOSS_TYPE,
            pre_nms_topk_train=cn.PRE_NMS_TOPK_TRAIN,
            post_nms_topk_train=cn.POST_NMS_TOPK_TRAIN,
            pre_nms_topk_test=cn.PRE_NMS_TOPK_TEST,
            post_nms_topk_test=cn.POST_NMS_TOPK_TEST,
            nms_thresh_train=cn.NMS_TH_TRAIN,
            nms_thresh_test=cn.NMS_TH_TEST,
            num_cls_convs=cn.NUM_CLS_CONVS,
            num_box_convs=cn.NUM_BOX_CONVS,
            num_share_convs=cn.NUM_SHARE_CONVS,
            norm=cn.NORM,
            prior_prob=cn.PRIOR_PROB,
            only_proposal=cn.ONLY_PROPOSAL,
            with_agn_hm=cn.WITH_AGN_HM,
            num_classes=cn.NUM_CLASSES,
        )


class CenterNetHead(nn.Module):
    """Conv towers + (agn_hm, bbox) outputs, shared over the levels of
    ``cfg.in_features``, ``in_channels`` channels each; with
    ``only_proposal=False`` also a class tower and ``cls_logits`` of
    ``num_classes`` channels (the standalone detector)."""

    def __init__(self, cfg: CenterNetConfig, in_channels: int = 256, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        kw = dict(dtype=dtype, device=device)

        def tower(name: str, count: int) -> List[str]:
            names = [f"{name}_{i}" for i in range(count)]
            for n in names:
                self.add_module(n, ConvNorm(in_channels, in_channels, 3, 1, c.norm, F.relu, **kw))
            return names

        self._share = tower("share", c.num_share_convs)
        self._bbox = tower("bbox", c.num_box_convs)
        self._cls = tower("cls", 0 if c.only_proposal else c.num_cls_convs)
        self.cls_logits = None
        if not c.only_proposal:
            self.cls_logits = ConvNorm(in_channels, c.num_classes, 3, 1, "", None, use_bias=True,
                                       **kw)
        self.agn_hm = None
        if c.with_agn_hm:
            self.agn_hm = ConvNorm(in_channels, 1, 3, 1, "", None, use_bias=True, **kw)
        self.bbox_pred = ConvNorm(in_channels, 4, 3, 1, "", None, use_bias=True, **kw)
        for l in range(len(c.in_features)):
            self.add_module(f"scale_{l}", Scale(device=device))

    def forward(self, features: Sequence[torch.Tensor]):
        """Per level: (agn_hm (B, H, W) or None, bbox_reg (B, H, W, 4) ≥ 0,
        class logits (B, H, W, C) or None), the JAX module's triple."""
        agn_hms, bbox_regs, clss = [], [], []
        for l, x in enumerate(features):
            for n in self._share:
                x = getattr(self, n)(x)
            bx = x
            for n in self._bbox:
                bx = getattr(self, n)(bx)
            if self.cls_logits is not None:
                cx = x
                for n in self._cls:
                    cx = getattr(self, n)(cx)
                clss.append(self.cls_logits(cx))
            else:
                clss.append(None)
            agn_hms.append(self.agn_hm(bx)[..., 0] if self.agn_hm is not None else None)
            bbox_regs.append(F.relu(getattr(self, f"scale_{l}")(self.bbox_pred(bx))))
        return agn_hms, bbox_regs, clss


def level_geometry(cfg: CenterNetConfig, feature_shapes: Sequence[Tuple[int, int]],
                   device=None) -> Dict:
    """Flattened grids, strides, size ranges and level ids, (M, …) each, plus
    the per-level shapes. Grid centres sit at ``s // 2`` of each cell."""
    grids, strides, ranges, level_ids = [], [], [], []
    f32 = dict(dtype=torch.float32, device=device)
    for l, (h, w) in enumerate(feature_shapes):
        s = cfg.strides[l]
        ys = torch.arange(h, **f32) * s + s // 2
        xs = torch.arange(w, **f32) * s + s // 2
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grids.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        strides.append(torch.full((h * w,), float(s), **f32))
        ranges.append(torch.tensor(cfg.sizes_of_interest[l], **f32)[None].repeat(h * w, 1))
        level_ids.append(torch.full((h * w,), l, dtype=torch.int32, device=device))
    return dict(grids=torch.cat(grids), strides=torch.cat(strides),
                size_ranges=torch.cat(ranges), level_ids=torch.cat(level_ids),
                shapes=tuple(tuple(s) for s in feature_shapes))


INF = 1e8  # marks "no ground truth at this location", as in the JAX package


def _ground_truth_single(cfg: CenterNetConfig, geom: Dict, boxes: torch.Tensor,
                         valid: torch.Tensor):
    grids, strides, size_ranges = geom["grids"], geom["strides"], geom["size_ranges"]
    m = grids.shape[0]
    gx, gy = grids[:, 0:1], grids[:, 1:2]  # (M, 1)
    l_ = gx - boxes[None, :, 0]  # (M, N)
    t_ = gy - boxes[None, :, 1]
    r_ = boxes[None, :, 2] - gx
    b_ = boxes[None, :, 3] - gy
    reg_target = torch.stack([l_, t_, r_, b_], dim=-1)  # (M, N, 4)

    centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0  # (N, 2)
    st = strides[:, None]  # (M, 1)
    # the centre's cell, truncated toward zero as an int32 cast does
    cdx = (centers[None, :, 0] / st).to(torch.int32).float() * st + st / 2
    cdy = (centers[None, :, 1] / st).to(torch.int32).float() * st + st / 2

    is_peak = (gx == cdx) & (gy == cdy)
    is_in_boxes = reg_target.amin(dim=-1) > 0
    is_center3x3 = ((gx - cdx).abs() <= st) & ((gy - cdy).abs() <= st) & is_in_boxes
    crit = torch.sqrt((l_ + r_) ** 2 + (t_ + b_) ** 2) / 2.0
    is_cared = (crit >= size_ranges[:, 0:1]) & (crit <= size_ranges[:, 1:2])
    reg_mask = is_center3x3 & is_cared & valid[None, :]

    dist2 = (gx - centers[None, :, 0]) ** 2 + (gy - centers[None, :, 1]) ** 2
    dist2 = torch.where(is_peak, torch.zeros_like(dist2), dist2)
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    radius2 = (cfg.delta ** 2 * 2.0 * area).clamp(min=cfg.min_radius ** 2)
    wd2 = dist2 / radius2[None, :]  # (M, N)

    # regression target: the nearest (weighted) cared ground truth per location
    inf = torch.full_like(wd2, INF)
    min_dist, min_idx = torch.where(reg_mask, wd2, inf).min(dim=1)
    reg_targets = torch.gather(reg_target, 1, min_idx[:, None, None].expand(m, 1, 4))[:, 0]
    reg_targets = torch.where(min_dist[:, None] >= INF, torch.full_like(reg_targets, -INF),
                              reg_targets)
    reg_targets = reg_targets / strides[:, None]

    hm = torch.exp(-torch.where(valid[None, :], wd2, inf).amin(dim=1))
    hm = torch.where(hm < 1e-4, torch.zeros_like(hm), hm)

    # positives: the discretized centre cell at every cared level, with multiplicity
    box_crit = torch.sqrt(((boxes[:, 2:] - boxes[:, :2]) ** 2).sum(dim=1)) / 2.0
    pos_count = torch.zeros(m, dtype=torch.int32, device=boxes.device)
    base = 0
    for lvl, (h, w) in enumerate(geom["shapes"]):
        s = float(cfg.strides[lvl])
        lo, hi = cfg.sizes_of_interest[lvl]
        cared = (box_crit >= lo) & (box_crit <= hi) & valid
        cx = (centers[:, 0] / s).to(torch.int32).clamp(0, w - 1)
        cy = (centers[:, 1] / s).to(torch.int32).clamp(0, h - 1)
        pos_count.index_add_(0, (base + cy * w + cx).long(), cared.to(torch.int32))
        base += h * w
    return reg_targets, hm, pos_count


def centernet_ground_truth(cfg: CenterNetConfig, geom: Dict, gt_boxes: torch.Tensor,
                           gt_valid: torch.Tensor):
    """Training targets from gt_boxes (B, N, 4) and gt_valid (B, N) bool:
    reg_targets (B, M, 4) in stride units (−INF where a location has no
    target), the agnostic heatmap (B, M), and pos_count (B, M) int32, the
    centre-cell positives with multiplicity."""
    per_image = [_ground_truth_single(cfg, geom, b.float(), v)
                 for b, v in zip(gt_boxes, gt_valid)]
    return tuple(torch.stack(t) for t in zip(*per_image))


def centernet_losses(cfg: CenterNetConfig, agn_hm_pred: torch.Tensor, reg_pred: torch.Tensor,
                     reg_targets: torch.Tensor, heatmaps: torch.Tensor,
                     pos_count: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``loss_centernet_loc``, ``loss_centernet_agn_pos`` and
    ``loss_centernet_agn_neg`` from agn_hm_pred (B, M) logits and reg_pred
    (B, M, 4) in stride units (one process, so the normalizers are this
    batch's own). With ``not_norm_reg`` off the regression is weighted by
    the heatmap's maximum over the image's locations, as the JAX package
    weights it: its maximum over the last axis of the (B, M) heatmap
    broadcasts against (B, M) only at B = 1, so other batch sizes raise."""
    num_pos_avg = pos_count.sum().float().clamp(min=1.0)
    reg_valid = reg_targets.amax(dim=-1) >= 0  # (B, M)
    reg_weight_map = reg_valid.float()
    if not cfg.not_norm_reg:
        if heatmaps.shape[0] != 1:
            raise ValueError(
                f"NOT_NORM_REG false at a batch of {heatmaps.shape[0]} images: the JAX "
                f"package's weight jnp.max(heatmaps, axis=-1), one value per image, "
                f"broadcasts against the (B, M) locations only at B = 1")
        reg_weight_map = torch.where(reg_valid, heatmaps.amax(dim=-1, keepdim=True),
                                     torch.zeros((), device=heatmaps.device))
    reg_norm = reg_weight_map.sum().clamp(min=1.0)

    flat_tgt = torch.where(reg_valid.reshape(-1, 1), reg_targets.reshape(-1, 4),
                           torch.zeros((), device=reg_targets.device))
    reg_loss = iou_loss(reg_pred.reshape(-1, 4), flat_tgt, weight=reg_weight_map.reshape(-1),
                        loss_type=cfg.loc_loss_type, reduction="sum")
    losses = {"loss_centernet_loc": cfg.reg_weight * reg_loss / reg_norm}
    pos_loss, neg_loss = heatmap_focal_loss(
        agn_hm_pred, heatmaps, pos_count, alpha=cfg.hm_focal_alpha, beta=cfg.hm_focal_beta,
        gamma=cfg.loss_gamma, sigmoid_clamp=cfg.sigmoid_clamp, ignore_high_fp=cfg.ignore_high_fp)
    losses["loss_centernet_agn_pos"] = cfg.pos_weight * pos_loss / num_pos_avg
    losses["loss_centernet_agn_neg"] = cfg.neg_weight * neg_loss / num_pos_avg
    return losses


def centernet_proposals(cfg: CenterNetConfig, geom: Dict, agn_hm_pred: torch.Tensor,
                        reg_pred: torch.Tensor, image_sizes: torch.Tensor,
                        training: bool) -> Dict[str, torch.Tensor]:
    """Decode the top-scoring proposals after NMS, with static shapes:
    agn_hm_pred (B, M) logits and reg_pred (B, M, 4) in stride units →
    boxes (B, K, 4), scores (B, K), valid (B, K), K = post_nms_topk.

    Per level: a threshold on ``sqrt(sigmoid)`` and a top-k; then a cap of
    ``pre_nms_total`` candidates; then one NMS across levels."""
    grids = geom["grids"]
    strides = geom["strides"]
    scores_all = torch.sqrt(torch.sigmoid(agn_hm_pred.float()))
    reg = reg_pred.float() * strides[None, :, None]
    x1 = grids[None, :, 0] - reg[..., 0]
    y1 = grids[None, :, 1] - reg[..., 1]
    x2 = torch.maximum(grids[None, :, 0] + reg[..., 2], x1 + 0.01)
    y2 = torch.maximum(grids[None, :, 1] + reg[..., 3], y1 + 0.01)
    boxes_all = torch.stack([x1, y1, x2, y2], dim=-1)  # (B, M, 4)

    pre_topk = cfg.pre_nms_topk_train if training else cfg.pre_nms_topk_test
    post_topk = cfg.post_nms_topk_train if training else cfg.post_nms_topk_test
    nms_th = cfg.nms_thresh_train if training else cfg.nms_thresh_test
    neg_inf = float("-inf")
    thresh = math.sqrt(cfg.score_thresh)

    out = []
    for scores, boxes in zip(scores_all, boxes_all):
        cand_scores, cand_boxes = [], []
        start = 0
        for h, w in geom["shapes"]:
            size = h * w
            s_l = scores[start:start + size]
            s_l = torch.where(s_l > thresh, s_l, torch.full_like(s_l, neg_inf))
            topv, topi = stable_topk(s_l, min(pre_topk, size))
            cand_scores.append(topv)
            cand_boxes.append(boxes[start:start + size][topi])
            start += size
        s = torch.cat(cand_scores)
        b = torch.cat(cand_boxes)
        topv, topi = stable_topk(s, min(cfg.pre_nms_total, s.shape[0]))
        b = b[topi]
        v = topv > neg_inf
        s = torch.where(v, topv, torch.zeros_like(topv))
        keep = nms_mask(b, s, nms_th, valid=v)
        out.append(top_scoring(b, s, keep, post_topk)[:3])
    boxes, scores, valid = (torch.stack(t) for t in zip(*out))
    return {"boxes": boxes, "scores": scores, "valid": valid}


def _classwise_single(cfg: CenterNetConfig, geom: Dict, boxes: torch.Tensor,
                      classes: torch.Tensor, valid: torch.Tensor):
    grids, strides = geom["grids"], geom["strides"]
    m, c = grids.shape[0], cfg.num_classes
    gx, gy = grids[:, 0:1], grids[:, 1:2]
    centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
    st = strides[:, None]
    cdx = (centers[None, :, 0] / st).to(torch.int32).float() * st + st / 2
    cdy = (centers[None, :, 1] / st).to(torch.int32).float() * st + st / 2
    is_peak = (gx == cdx) & (gy == cdy)
    dist2 = (gx - centers[None, :, 0]) ** 2 + (gy - centers[None, :, 1]) ** 2
    dist2 = torch.where(is_peak, torch.zeros_like(dist2), dist2)
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    radius2 = (cfg.delta ** 2 * 2.0 * area).clamp(min=cfg.min_radius ** 2)
    wd2 = dist2 / radius2[None, :]  # (M, N)
    hm_per_gt = torch.exp(-torch.where(valid[None, :], wd2, torch.full_like(wd2, INF)))
    # per class the maximum over its ground truths; invalid rows go to an
    # extra column that is dropped, empty classes stay at -inf and become 0
    seg = torch.where(valid, classes.long(), torch.full_like(classes.long(), c))
    hm_cls = torch.full((m, c + 1), float("-inf"), device=boxes.device).scatter_reduce(
        1, seg[None].expand(m, -1), hm_per_gt, "amax")[:, :c]
    hm_cls = torch.where(hm_cls < 1e-4, torch.zeros_like(hm_cls), hm_cls.clamp(min=0.0))

    box_crit = torch.sqrt(((boxes[:, 2:] - boxes[:, :2]) ** 2).sum(dim=1)) / 2.0
    pos = torch.zeros((m, c), dtype=torch.int32, device=boxes.device)
    cls_idx = classes.long().clamp(0, c - 1)
    base = 0
    for lvl, (h, w) in enumerate(geom["shapes"]):
        s = float(cfg.strides[lvl])
        lo, hi = cfg.sizes_of_interest[lvl]
        cared = (box_crit >= lo) & (box_crit <= hi) & valid
        cx = (centers[:, 0] / s).to(torch.int32).clamp(0, w - 1)
        cy = (centers[:, 1] / s).to(torch.int32).clamp(0, h - 1)
        pos.index_put_(((base + cy * w + cx).long(), cls_idx), cared.to(torch.int32),
                       accumulate=True)
        base += h * w
    return hm_cls, pos


def centernet_ground_truth_classwise(cfg: CenterNetConfig, geom: Dict, gt_boxes: torch.Tensor,
                                     gt_classes: torch.Tensor, gt_valid: torch.Tensor):
    """The standalone detector's targets: ``centernet_ground_truth``'s
    reg_targets and agnostic heatmap, per-class heatmaps (B, M, C) and the
    per-(location, class) positive counts (B, M, C) int32."""
    reg_targets, hm_agn, _ = centernet_ground_truth(cfg, geom, gt_boxes, gt_valid)
    per_image = [_classwise_single(cfg, geom, b.float(), k, v)
                 for b, k, v in zip(gt_boxes, gt_classes, gt_valid)]
    hm_cls, pos_cls = (torch.stack(t) for t in zip(*per_image))
    return reg_targets, hm_agn, hm_cls, pos_cls


def centernet_losses_classwise(cfg: CenterNetConfig, cls_logits: torch.Tensor,
                               agn_hm_pred: Optional[torch.Tensor], reg_pred: torch.Tensor,
                               reg_targets: torch.Tensor, hm_agn: torch.Tensor,
                               hm_cls: torch.Tensor,
                               pos_cls: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The standalone detector's losses: ``centernet_losses`` over the
    positive locations of every class (without the agnostic terms when
    ``agn_hm_pred`` is None), plus the classwise focal terms
    ``loss_centernet_pos`` and ``loss_centernet_neg`` of cls_logits
    (B, M, C)."""
    losses = centernet_losses(
        cfg, agn_hm_pred if agn_hm_pred is not None else torch.zeros_like(hm_agn), reg_pred,
        reg_targets, hm_agn, pos_cls.sum(dim=-1))
    if agn_hm_pred is None:
        losses.pop("loss_centernet_agn_pos")
        losses.pop("loss_centernet_agn_neg")
    num_pos_avg = pos_cls.sum().float().clamp(min=1.0)
    pos_loss, neg_loss = heatmap_focal_loss(
        cls_logits.float(), hm_cls, pos_cls, alpha=cfg.hm_focal_alpha, beta=cfg.hm_focal_beta,
        gamma=cfg.loss_gamma, sigmoid_clamp=cfg.sigmoid_clamp, ignore_high_fp=cfg.ignore_high_fp)
    losses["loss_centernet_pos"] = cfg.pos_weight * pos_loss / num_pos_avg
    losses["loss_centernet_neg"] = cfg.neg_weight * neg_loss / num_pos_avg
    return losses


def centernet_detections(cfg: CenterNetConfig, geom: Dict, cls_logits: torch.Tensor,
                         agn_hm_pred: Optional[torch.Tensor], reg_pred: torch.Tensor,
                         image_sizes: torch.Tensor, training: bool) -> Dict[str, torch.Tensor]:
    """Classwise decoding: cls_logits (B, M, C), agn_hm_pred (B, M) or None,
    reg_pred (B, M, 4) → boxes (B, K, 4), scores (B, K), classes (B, K),
    valid (B, K), K = post_nms_topk. Candidates are the (location, class)
    pairs whose class heatmap passes ``score_thresh``; the score is
    ``sqrt(class · agnostic)`` with the agnostic heatmap; per level a top-k
    of the flattened pairs, then ``pre_nms_total`` across levels, then one
    class-aware NMS."""
    grids, strides = geom["grids"], geom["strides"]
    c = cfg.num_classes
    hm = torch.sigmoid(cls_logits.float())
    cand = hm > cfg.score_thresh  # the threshold is on the raw classwise heatmap
    if agn_hm_pred is not None:
        hm = hm * torch.sigmoid(agn_hm_pred.float())[..., None]
    scores_all = torch.sqrt(hm) if cfg.with_agn_hm else hm
    reg = reg_pred.float() * strides[None, :, None]
    x1 = grids[None, :, 0] - reg[..., 0]
    y1 = grids[None, :, 1] - reg[..., 1]
    x2 = torch.maximum(grids[None, :, 0] + reg[..., 2], x1 + 0.01)
    y2 = torch.maximum(grids[None, :, 1] + reg[..., 3], y1 + 0.01)
    boxes_all = torch.stack([x1, y1, x2, y2], dim=-1)

    pre_topk = cfg.pre_nms_topk_train if training else cfg.pre_nms_topk_test
    post_topk = cfg.post_nms_topk_train if training else cfg.post_nms_topk_test
    nms_th = cfg.nms_thresh_train if training else cfg.nms_thresh_test
    neg_inf = float("-inf")
    out = []
    for scores, ok, boxes in zip(scores_all, cand, boxes_all):
        cs, cb, cc = [], [], []
        start = 0
        for h, w in geom["shapes"]:
            size = h * w
            flat = torch.where(ok[start:start + size], scores[start:start + size],
                               torch.full_like(scores[start:start + size], neg_inf)).reshape(-1)
            topv, topi = stable_topk(flat, min(pre_topk, flat.shape[0]))
            cs.append(topv)
            cb.append(boxes[start:start + size][topi // c])
            cc.append(topi % c)
            start += size
        s, b, cl = torch.cat(cs), torch.cat(cb), torch.cat(cc)
        topv, topi = stable_topk(s, min(cfg.pre_nms_total, s.shape[0]))
        b, cl = b[topi], cl[topi]
        v = topv > neg_inf
        s = torch.where(v, topv, torch.zeros_like(topv))
        keep = batched_nms_mask(b, s, cl, nms_th, valid=v)
        ob, os_, ov, _, (ocls,) = top_scoring(b, s, keep, post_topk, extras=(cl,))
        out.append((ob, os_, ocls, ov))
    boxes, scores, classes, valid = (torch.stack(t) for t in zip(*out))
    return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}
