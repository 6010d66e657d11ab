"""Detic cascade ROI heads (torch): the inference forward, static shapes.

Counterpart of ``divergen_tpu/modeling/roi_heads/cascade_heads.py``: a
three-stage cascade (``FastRCNNConvFCHead`` + ``DeticOutputLayers`` per
stage, sigmoid class scores averaged over the stages, class-agnostic box
regression, ``mult_proposal_score`` fusion), fixed-capacity class-aware NMS
(``_fast_rcnn_inference_single``) and ``MaskRCNNConvUpsampleHead`` on the
kept boxes. Proposals are (B, P, 4) with validity and detections are padded
to ``detections_per_image`` with a ``valid`` mask, as in the JAX package.
Children carry the flax scope names (``box_head0.fc1``,
``box_predictor0.cls_score``, ``mask_head.deconv``, …).

Not ported yet, with the training slice: ``losses``, ``image_label_losses``,
``_mask_loss``, proposal matching and sampling, the caption columns and the
sampled vocabulary of the zero-shot classifier, the WSDDN proposal-score
branch, and ``RefineMaskHead``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nms import batched_nms_mask, stable_topk, top_scoring
from ...ops.roi_align import multilevel_roi_align
from ...structures import boxes as box_ops
from ..layers import Conv, ConvTranspose, Dense
from . import box_regression


@dataclasses.dataclass(frozen=True)
class ROIHeadsConfig:
    num_classes: int = 1203
    in_features: Tuple[str, ...] = ("p3", "p4", "p5")
    strides: Tuple[int, ...] = (8, 16, 32)
    cascade_ious: Tuple[float, ...] = (0.6, 0.7, 0.8)
    cascade_reg_weights: Tuple[Tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    pooler_resolution: int = 7
    mask_pooler_resolution: int = 14
    fc_dim: int = 1024
    num_fc: int = 2
    mask_num_conv: int = 4
    mask_conv_dim: int = 256
    mask_on: bool = True
    mask_weight: float = 1.0
    mask_fg_capacity: int = 128  # static cap on fg rows fed to the mask head
    cls_agnostic_bbox_reg: bool = True
    smooth_l1_beta: float = 0.0
    box_reg_loss_type: str = "smooth_l1"
    use_sigmoid_ce: bool = True
    use_fed_loss: bool = True
    fed_loss_num_cat: int = 50
    prior_prob: float = 0.01
    score_thresh_test: float = 0.02
    nms_thresh_test: float = 0.5
    detections_per_image: int = 300
    # static pre-NMS candidate cap (0 → detections_per_image * 4): the
    # reference NMS-es EVERY (proposal, class) above the score threshold;
    # raise this when exact tail parity matters more than NMS cost
    nms_candidates: int = 0
    mult_proposal_score: bool = True
    one_class_per_proposal: bool = False
    add_gt_to_proposals: bool = True
    divergen_box_loss: bool = True  # True → no instance_source box-loss mask
    divergen_mask_loss: bool = True  # True → mask head also trains on pastes
    norm_temp: float = 50.0
    use_zeroshot_cls: bool = False
    split_paste_loss: bool = False  # BSGAL per-source CE keys
    # per-paste-instance loss columns (BSGAL ACTIVE_ONLY_GT_TRAIN)
    per_paste_loss: bool = False
    mask_head_name: str = "MaskRCNNConvUpsampleHead"  # or RefineMaskHead
    sem_seg_weight: float = 0.25
    # RefineMask: supervision sizes per stage and class-agnostic prediction
    stage_sup_size: Tuple[int, ...] = (14, 28, 56, 112)
    cls_agnostic_mask: bool = True
    # weak supervision on image-labeled data
    with_image_labels: bool = False
    image_label_loss: str = "max_size"  # max_size|max_score|first|image|min_loss|wsddn|wsod
    image_loss_weight: float = 0.1
    add_image_box: bool = False
    image_box_size: float = 1.0
    ws_num_props: int = 128
    with_softmax_prop: bool = False
    softmax_weak_loss: bool = False
    caption_weight: float = 1.0
    neg_cap_weight: float = 0.125
    sync_caption_batch: bool = False

    @staticmethod
    def from_cfg(cfg) -> "ROIHeadsConfig":
        r = cfg.MODEL.ROI_HEADS
        b = cfg.MODEL.ROI_BOX_HEAD
        mk = cfg.MODEL.ROI_MASK_HEAD
        cas = cfg.MODEL.ROI_BOX_CASCADE_HEAD
        return ROIHeadsConfig(
            num_classes=r.NUM_CLASSES,
            in_features=tuple(r.IN_FEATURES),
            strides=tuple(2 ** int(f[-1]) for f in r.IN_FEATURES),
            cascade_ious=tuple(cas.IOUS),
            cascade_reg_weights=tuple(tuple(w) for w in cas.BBOX_REG_WEIGHTS),
            batch_size_per_image=r.BATCH_SIZE_PER_IMAGE,
            positive_fraction=r.POSITIVE_FRACTION,
            pooler_resolution=b.POOLER_RESOLUTION,
            mask_pooler_resolution=mk.POOLER_RESOLUTION,
            fc_dim=b.FC_DIM,
            num_fc=b.NUM_FC,
            mask_num_conv=mk.NUM_CONV,
            mask_conv_dim=mk.CONV_DIM,
            mask_on=cfg.MODEL.MASK_ON,
            mask_weight=r.MASK_WEIGHT,
            cls_agnostic_bbox_reg=b.CLS_AGNOSTIC_BBOX_REG,
            smooth_l1_beta=b.SMOOTH_L1_BETA,
            box_reg_loss_type=b.BBOX_REG_LOSS_TYPE,
            split_paste_loss=cfg.MODEL.ACTIVE.ENABLED,
            per_paste_loss=cfg.MODEL.ACTIVE.ENABLED
            and (cfg.MODEL.ACTIVE.ONLY_GT_TRAIN or cfg.MODEL.ACTIVE.PER_INSTANCE),
            mask_head_name=mk.NAME,
            sem_seg_weight=mk.SEM_SEG_WEIGHT,
            stage_sup_size=tuple(mk.STAGE_SUP_SIZE),
            cls_agnostic_mask=mk.CLS_AGNOSTIC_MASK,
            use_sigmoid_ce=b.USE_SIGMOID_CE,
            use_fed_loss=b.USE_FED_LOSS,
            fed_loss_num_cat=b.FED_LOSS_NUM_CAT,
            prior_prob=b.PRIOR_PROB,
            score_thresh_test=r.SCORE_THRESH_TEST,
            nms_thresh_test=r.NMS_THRESH_TEST,
            detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            nms_candidates=cfg.TEST.NMS_CANDIDATES,
            mult_proposal_score=b.MULT_PROPOSAL_SCORE,
            one_class_per_proposal=r.ONE_CLASS_PER_PROPOSAL,
            add_gt_to_proposals=r.PROPOSAL_APPEND_GT,
            divergen_box_loss=cfg.MODEL.get("USE_DIVERGEN_BOX_LOSS", True)
            and cfg.MODEL.get("USE_XPASTE_BOX_LOSS", True),
            divergen_mask_loss=cfg.MODEL.get("USE_DIVERGEN_MASK_LOSS", True)
            and cfg.MODEL.get("USE_XPASTE_MASK_LOSS", True),
            norm_temp=b.NORM_TEMP,
            use_zeroshot_cls=b.USE_ZEROSHOT_CLS,
            with_image_labels=cfg.WITH_IMAGE_LABELS,
            image_label_loss=b.IMAGE_LABEL_LOSS,
            image_loss_weight=b.IMAGE_LOSS_WEIGHT,
            add_image_box=b.ADD_IMAGE_BOX,
            image_box_size=b.IMAGE_BOX_SIZE,
            ws_num_props=b.WS_NUM_PROPS,
            with_softmax_prop=b.WITH_SOFTMAX_PROP,
            softmax_weak_loss=b.SOFTMAX_WEAK_LOSS,
            caption_weight=b.CAPTION_WEIGHT,
            neg_cap_weight=b.NEG_CAP_WEIGHT,
            sync_caption_batch=cfg.MODEL.SYNC_CAPTION_BATCH,
        )


class FastRCNNConvFCHead(nn.Module):
    """Box feature head: flatten (r, r, C) row-major, then ``num_fc`` ×
    (FC + ReLU)."""

    def __init__(self, in_features: int, fc_dim: int = 1024, num_fc: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Dense(in_features if i == 0 else fc_dim, fc_dim,
                                                dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class DeticOutputLayers(nn.Module):
    """Class scores and box deltas of one cascade stage: ``(scores (N, C + 1),
    deltas (N, 4 or 4·C))``.

    The zero-shot variant projects to ``zs_dim``, L2-normalizes features and
    the ``zs_weight`` (zs_dim, C) columns, scales by ``norm_temp`` and appends
    the ``bg_bias`` column."""

    raw_init_std = {"zs_weight": 0.01}

    def __init__(self, in_features: int, num_classes: int, prior_prob: float = 0.01,
                 cls_agnostic: bool = True, use_sigmoid_ce: bool = True,
                 use_zeroshot_cls: bool = False, zs_dim: int = 512, norm_temp: float = 50.0,
                 with_softmax_prop: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        if with_softmax_prop:
            raise NotImplementedError("the WSDDN proposal-score branch is not yet ported")
        self.num_classes, self.norm_temp = num_classes, norm_temp
        self.use_zeroshot_cls = use_zeroshot_cls
        bias_value = -math.log((1 - prior_prob) / prior_prob) if use_sigmoid_ce else 0.0
        kw = dict(dtype=dtype, device=device)
        if use_zeroshot_cls:
            self.linear = Dense(in_features, zs_dim, **kw)
            self.zs_weight = nn.Parameter(torch.zeros(zs_dim, num_classes, device=device))
            self.bg_bias = nn.Parameter(torch.full((1,), bias_value, device=device))
        else:
            self.cls_score = Dense(in_features, num_classes + 1, **kw)
        self.bbox_pred = Dense(in_features, 4 if cls_agnostic else 4 * num_classes, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.use_zeroshot_cls:
            emb = self.linear(x)
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp(min=1e-6)
            zs = self.zs_weight
            zs = zs / torch.linalg.norm(zs, dim=0, keepdim=True).clamp(min=1e-6)
            # float32 weights against features in the compute dtype promote
            cls_logits = self.norm_temp * (emb.to(torch.promote_types(emb.dtype, zs.dtype)) @ zs)
            bg = self.bg_bias.to(cls_logits.dtype).expand(x.shape[0], 1)
            scores = torch.cat([cls_logits, bg], dim=-1)
        else:
            scores = self.cls_score(x)
        return scores, self.bbox_pred(x)


class MaskRCNNConvUpsampleHead(nn.Module):
    """``num_conv`` × (3×3 conv + ReLU), a ×2 transposed conv + ReLU and a 1×1
    predictor, class-agnostic: (N, r, r, C) → (N, 2r, 2r) logits."""

    def __init__(self, in_channels: int, num_conv: int = 4, conv_dim: int = 256,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_conv = num_conv
        kw = dict(dtype=dtype, device=device)
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", Conv(in_channels if i == 0 else conv_dim,
                                                     conv_dim, 3, **kw))
        self.deconv = ConvTranspose(conv_dim if num_conv else in_channels, conv_dim, 2, **kw)
        self.predictor = Conv(conv_dim, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))[..., 0]


class CascadeROIHeads(nn.Module):
    """Cascade box heads + mask head over FPN features of ``in_channels``
    channels. ``inference`` returns padded detections; the training entry
    points are not ported yet."""

    def __init__(self, cfg: ROIHeadsConfig, in_channels: int = 256, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        kw = dict(dtype=dtype, device=device)
        self.num_stages = len(c.cascade_ious)
        pooled = in_channels * c.pooler_resolution ** 2
        for k in range(self.num_stages):
            self.add_module(f"box_head{k}", FastRCNNConvFCHead(pooled, c.fc_dim, c.num_fc, **kw))
            self.add_module(f"box_predictor{k}", DeticOutputLayers(
                c.fc_dim if c.num_fc else pooled, c.num_classes, prior_prob=c.prior_prob,
                cls_agnostic=c.cls_agnostic_bbox_reg, use_sigmoid_ce=c.use_sigmoid_ce,
                use_zeroshot_cls=c.use_zeroshot_cls, norm_temp=c.norm_temp,
                with_softmax_prop=c.with_softmax_prop, **kw))
        self.mask_head = None
        if c.mask_on:
            if c.mask_head_name == "RefineMaskHead":
                raise NotImplementedError("RefineMaskHead is not yet ported")
            self.mask_head = MaskRCNNConvUpsampleHead(in_channels, c.mask_num_conv,
                                                      c.mask_conv_dim, **kw)

    def _pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
              resolution: int) -> torch.Tensor:
        """Multi-level ROIAlign per image: boxes (B, P, 4) → (B·P, r, r, C)."""
        c = self.cfg
        pooled = [multilevel_roi_align([features[f][i] for f in c.in_features], list(c.strides),
                                       boxes[i], resolution) for i in range(boxes.shape[0])]
        return torch.cat(pooled)

    def _run_stage(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor, stage: int):
        """ROIAlign + box head + predictor of one stage: boxes (B, P, 4) →
        (scores (B, P, C + 1), deltas (B, P, 4))."""
        b, p = boxes.shape[:2]
        pooled = self._pool(features, boxes, self.cfg.pooler_resolution)
        box_feat = getattr(self, f"box_head{stage}")(pooled)
        scores, deltas = getattr(self, f"box_predictor{stage}")(box_feat)
        return scores.reshape(b, p, -1), deltas.reshape(b, p, -1)

    def losses(self, *args, **kwargs):
        raise NotImplementedError("CascadeROIHeads.losses is not yet ported")

    def image_label_losses(self, *args, **kwargs):
        raise NotImplementedError("CascadeROIHeads.image_label_losses is not yet ported")

    def inference(self, features: Dict[str, torch.Tensor], proposals: Dict[str, torch.Tensor],
                  image_sizes: torch.Tensor, return_logits: bool = False) -> Dict[str, torch.Tensor]:
        """features: FPN maps (B, H_l, W_l, C) by name; proposals: boxes
        (B, P, 4), scores (B, P), valid (B, P); image_sizes (B, 2) as (h, w).
        Returns ``prop_idx``, ``boxes``, ``scores``, ``classes``, ``valid``
        (B, K, …) with K = detections_per_image, ``logits`` (B, K, C) with
        ``return_logits`` and ``mask_logits`` (B, K, 2r, 2r) with a mask
        head."""
        c = self.cfg
        boxes = proposals["boxes"].float()
        prop_scores = proposals["scores"]
        b, p = boxes.shape[:2]
        scores_sum = torch.zeros((b, p, c.num_classes + 1), dtype=torch.float32,
                                 device=boxes.device)
        for stage in range(self.num_stages):
            scores, deltas = self._run_stage(features, boxes, stage)
            if c.use_sigmoid_ce:
                probs = torch.sigmoid(scores.float())
            else:
                probs = torch.softmax(scores.float(), dim=-1)
            scores_sum = scores_sum + probs
            boxes = box_regression.apply_deltas(deltas.float(), boxes,
                                                c.cascade_reg_weights[stage])
            if stage + 1 < self.num_stages:
                # refined boxes are clipped to the image before the next stage
                boxes = box_ops.clip(boxes, image_sizes)
        scores_avg = scores_sum / self.num_stages
        if c.mult_proposal_score:
            scores_avg = torch.sqrt(scores_avg * prop_scores.float().clamp(min=0.0)[..., None])
        if c.one_class_per_proposal:
            best = scores_avg[..., :-1].max(dim=-1, keepdim=True).values
            scores_avg = scores_avg * (scores_avg >= best)
        cls_scores = scores_avg[..., :-1]  # drop background

        per_image = [_fast_rcnn_inference_single(c, boxes[i], cls_scores[i],
                                                 proposals["valid"][i], image_sizes[i])
                     for i in range(b)]
        dets = {k: torch.stack([d[k] for d in per_image]) for k in per_image[0]}
        if return_logits:
            # the averaged cascade scores of each detection's source proposal
            index = dets["prop_idx"][..., None].expand(-1, -1, cls_scores.shape[-1])
            dets["logits"] = torch.gather(cls_scores, 1, index)
        if self.mask_head is not None:
            k = dets["boxes"].shape[1]
            mask_logits = self.mask_head(self._pool(features, dets["boxes"],
                                                    c.mask_pooler_resolution))
            dets["mask_logits"] = mask_logits.reshape(b, k, *mask_logits.shape[-2:])
        return dets


def _fast_rcnn_inference_single(c: ROIHeadsConfig, boxes: torch.Tensor, scores: torch.Tensor,
                                valid: torch.Tensor, image_size) -> Dict[str, torch.Tensor]:
    """Per image: class threshold → the top ``nms_candidates`` (4 ×
    ``detections_per_image`` by default) of the P·C flat scores → class-aware
    NMS → the top ``detections_per_image``. boxes (P, 4), scores (P, C)."""
    p, num_c = scores.shape
    boxes = box_ops.clip(boxes, image_size)
    flat = torch.where(valid[:, None], scores, torch.zeros_like(scores)).reshape(-1)
    flat = torch.where(flat > c.score_thresh_test, flat, torch.full_like(flat, float("-inf")))
    cand = min(c.nms_candidates or c.detections_per_image * 4, flat.shape[0])
    topv, topi = stable_topk(flat, cand)
    prop_idx = topi // num_c
    cls_idx = topi % num_c
    cboxes = boxes[prop_idx]
    cvalid = topv > float("-inf")
    cscores = torch.where(cvalid, topv, torch.zeros_like(topv))
    keep = batched_nms_mask(cboxes, cscores, cls_idx, c.nms_thresh_test, cvalid)
    out_boxes, out_scores, out_valid, _, (out_classes, out_prop) = top_scoring(
        cboxes, cscores, keep, c.detections_per_image, extras=(cls_idx, prop_idx))
    return {"prop_idx": out_prop, "boxes": out_boxes, "scores": out_scores,
            "classes": out_classes, "valid": out_valid}
