"""CenterNet2 proposal generator (torch): head and proposal decoding.

Counterpart of ``divergen_tpu/modeling/centernet/centernet.py`` for the
inference forward: ``CenterNetConfig``, ``CenterNetHead`` (conv towers shared
over the levels with a per-level ``Scale``), ``level_geometry`` and
``centernet_proposals`` over a flattened level axis M = Σ_l H_l·W_l with
static shapes. The ground truth, the losses and the classwise
``centernet_detections`` belong to the training slice and the standalone
detector and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nms import nms_mask, stable_topk, top_scoring
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
    ``cfg.in_features``, ``in_channels`` channels each. The classwise head of
    the standalone detector (``only_proposal=False``) is not ported yet."""

    def __init__(self, cfg: CenterNetConfig, in_channels: int = 256, dtype=torch.float32,
                 device=None):
        super().__init__()
        if not cfg.only_proposal:
            raise NotImplementedError("the classwise CenterNet head is not yet ported")
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
        self.agn_hm = None
        if c.with_agn_hm:
            self.agn_hm = ConvNorm(in_channels, 1, 3, 1, "", None, use_bias=True, **kw)
        self.bbox_pred = ConvNorm(in_channels, 4, 3, 1, "", None, use_bias=True, **kw)
        for l in range(len(c.in_features)):
            self.add_module(f"scale_{l}", Scale(device=device))

    def forward(self, features: Sequence[torch.Tensor]):
        """Per level: (agn_hm (B, H, W) or None, bbox_reg (B, H, W, 4) ≥ 0,
        None for the classwise scores), the JAX module's triple."""
        agn_hms, bbox_regs, clss = [], [], []
        for l, x in enumerate(features):
            for n in self._share:
                x = getattr(self, n)(x)
            bx = x
            for n in self._bbox:
                bx = getattr(self, n)(bx)
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
