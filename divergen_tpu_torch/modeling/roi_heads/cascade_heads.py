"""Detic cascade ROI heads (torch): losses and inference, static shapes.

Counterpart of ``divergen_tpu/modeling/roi_heads/cascade_heads.py``: a
three-stage cascade (``FastRCNNConvFCHead`` + ``DeticOutputLayers`` per
stage, sigmoid class scores averaged over the stages, class-agnostic box
regression, ``mult_proposal_score`` fusion), fixed-capacity class-aware NMS
(``_fast_rcnn_inference_single``) and ``MaskRCNNConvUpsampleHead`` on the
kept boxes. Proposals are (B, P, 4) with validity and detections are padded
to ``detections_per_image`` with a ``valid`` mask, as in the JAX package.
Children carry the flax scope names (``box_head0.fc1``,
``box_predictor0.cls_score``, ``mask_head.deconv``, …).

Training: ``CascadeROIHeads.losses`` (matching, sampling, per-stage
``_fast_rcnn_losses`` with the federated class mask, ``_mask_loss``) returns
the JAX package's loss dict. Its random draws come through
``ops.losses.uniform_draw``: ``match`` and ``mask`` of shape (B, P + N) and
``fed0``, ``fed1``, ``fed2`` of shape (C + 1,).

With ``mask_head_name="RefineMaskHead"`` the mask head is
``refine_mask_head.RefineMaskHead`` with its ``semantic_branch`` over the
first ROI level: the loss is the staged ``refine_cross_entropy`` (a target
per supervision size), inference returns the composed final-size logits, and
a ground truth with ``sem_seg`` adds ``loss_semantic``.

Weak supervision: ``CascadeROIHeads.image_label_losses`` scores the top
``ws_num_props`` proposals (and the optional whole-image box) at every stage
and supervises one proposal per image label (``_weak_image_loss``: the
strategies ``max_size``, ``max_score``, ``first``, ``image``, ``min_loss``,
``wsddn`` and ``wsod``); caption embeddings append L2-normalised columns to
the zero-shot scores and add the caption loss on the image box. As in the JAX
module, the cascade's predictors are built without the WSDDN proposal-score
branch whatever ``with_softmax_prop`` says, so ``wsddn`` takes the class
scores as proposal scores there; ``Res5ROIHeads`` builds the branch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.losses import (Rng, get_fed_loss_classes, giou_loss_xyxy, optax_sigmoid_bce,
                           smooth_l1_loss, uniform_draw)
from ...ops.nms import batched_nms_mask, stable_topk, top_scoring
from ...ops.roi_align import multilevel_roi_align, roi_align
from ...structures import boxes as box_ops
from ...structures.masks import mask_target_in_box
from ..layers import Conv, ConvTranspose, Dense, resize_nearest
from . import box_regression
from .refine_mask_head import (RefineMaskHead, SemanticBranch, compose_stage_preds,
                               refine_cross_entropy)


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
    the ``bg_bias`` column. ``with_softmax_prop`` adds the WSDDN
    proposal-score branch (``prop_score_fc`` → ReLU → ``prop_score_out``,
    C + 1 columns), read by ``prop_score``."""

    raw_init_std = {"zs_weight": 0.01}

    def __init__(self, in_features: int, num_classes: int, prior_prob: float = 0.01,
                 cls_agnostic: bool = True, use_sigmoid_ce: bool = True,
                 use_zeroshot_cls: bool = False, zs_dim: int = 512, norm_temp: float = 50.0,
                 with_softmax_prop: bool = False, dtype=torch.float32, device=None):
        super().__init__()
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
        self.with_softmax_prop = with_softmax_prop
        if with_softmax_prop:
            self.prop_score_fc = Dense(in_features, in_features, **kw)
            self.prop_score_out = Dense(in_features, num_classes + 1, **kw)

    def forward(self, x: torch.Tensor, cls_inds: Optional[torch.Tensor] = None,
                cap_classifier: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``cls_inds`` (K,) restricts the zero-shot classifier to a sampled
        vocabulary (the dynamic classifier): scores are then (N, K + 1).
        ``cap_classifier`` (zs_dim, N_cap) appends N_cap caption columns,
        scored against the same normalized embedding (zero-shot only)."""
        if self.use_zeroshot_cls:
            emb = self.linear(x)
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp(min=1e-6)
            zs = self.zs_weight
            zs = zs / torch.linalg.norm(zs, dim=0, keepdim=True).clamp(min=1e-6)
            if cls_inds is not None:
                zs = zs[:, cls_inds]
            # float32 weights against features in the compute dtype promote
            cls_logits = self.norm_temp * (emb.to(torch.promote_types(emb.dtype, zs.dtype)) @ zs)
            bg = self.bg_bias.to(cls_logits.dtype).expand(x.shape[0], 1)
            scores = torch.cat([cls_logits, bg], dim=-1)
            if cap_classifier is not None:
                capw = cap_classifier / torch.linalg.norm(cap_classifier, dim=0,
                                                          keepdim=True).clamp(min=1e-6)
                cap_scores = self.norm_temp * (emb @ capw.to(emb.dtype))
                scores = torch.cat([scores, cap_scores.to(scores.dtype)], dim=-1)
        else:
            if cap_classifier is not None:
                raise ValueError("the caption loss needs the zero-shot classifier "
                                 "(MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS)")
            scores = self.cls_score(x)
        return scores, self.bbox_pred(x)

    def prop_score(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The WSDDN proposal scores (N, C + 1), or None without the branch."""
        if not self.with_softmax_prop:
            return None
        return self.prop_score_out(F.relu(self.prop_score_fc(x)))


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


def match_proposals(proposal_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_valid: torch.Tensor, iou_thresh: float):
    """detectron2's Matcher with one threshold: proposal_boxes (P, 4) against
    gt_boxes (N, 4) → (matched_idx (P,), fg (P,) bool). Invalid ground-truth
    rows never match."""
    iou = box_ops.pairwise_iou(gt_boxes, proposal_boxes)  # (N, P)
    iou = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))
    matched_iou, matched_idx = iou.max(dim=0)
    return matched_idx, matched_iou >= iou_thresh


def subsample_proposals(r: torch.Tensor, fg: torch.Tensor, valid: torch.Tensor,
                        num_samples: int, positive_fraction: float):
    """detectron2's ``subsample_labels`` with static shapes: up to
    ``positive_fraction · num_samples`` positives, the rest negatives, chosen
    by the uniform priorities ``r`` (P,). Returns (indices (num_samples,),
    validity). Positives beyond the budget are left out, not recycled as
    negatives."""
    p = fg.shape[0]
    num_samples = min(num_samples, p)
    max_pos = int(num_samples * positive_fraction)
    inf = torch.full_like(r, float("inf"))
    pos_rank = torch.argsort(torch.argsort(torch.where(fg & valid, r, inf), stable=True),
                             stable=True)
    keep_pos = fg & valid & (pos_rank < max_pos)
    priority = torch.where(keep_pos, 2.0 + r, torch.where(valid & ~fg, r, -inf))
    topv, topi = stable_topk(priority, num_samples)
    return topi, topv > float("-inf")


class _ScaleGradient(torch.autograd.Function):
    """The identity whose gradient is multiplied by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    return _ScaleGradient.apply(x, scale)


class CascadeROIHeads(nn.Module):
    """Cascade box heads + mask head over FPN features of ``in_channels``
    channels. ``losses`` returns the training loss dict (``loss_cls_stage{k}``,
    ``loss_box_reg_stage{k}``, ``loss_mask``), ``inference`` padded
    detections."""

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
                use_zeroshot_cls=c.use_zeroshot_cls, norm_temp=c.norm_temp, **kw))
        self.mask_head = None
        self.refine = c.mask_on and c.mask_head_name == "RefineMaskHead"
        if self.refine:
            n_sup = len(c.stage_sup_size)
            # the last stage is class-agnostic whatever CLS_AGNOSTIC_MASK says
            stage_ncls = tuple(1 if c.cls_agnostic_mask else c.num_classes
                               for _ in range(n_sup - 1)) + (1,)
            self.mask_head = RefineMaskHead(in_channels, c.mask_conv_dim, c.mask_conv_dim,
                                            stage_sup_size=c.stage_sup_size,
                                            stage_num_classes=stage_ncls, **kw)
            self.semantic_branch = SemanticBranch(in_channels, c.mask_conv_dim, **kw)
        elif c.mask_on:
            self.mask_head = MaskRCNNConvUpsampleHead(in_channels, c.mask_num_conv,
                                                      c.mask_conv_dim, **kw)

    def _pool(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
              resolution: int) -> torch.Tensor:
        """Multi-level ROIAlign per image: boxes (B, P, 4) → (B·P, r, r, C)."""
        c = self.cfg
        pooled = [multilevel_roi_align([features[f][i] for f in c.in_features], list(c.strides),
                                       boxes[i], resolution) for i in range(boxes.shape[0])]
        return torch.cat(pooled)

    def _refine_stages(self, features: Dict[str, torch.Tensor], pooled: torch.Tensor,
                       boxes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """RefineMask's per-stage logits for (B·K, r, r, C) pooled features
        of boxes (B, K, 4); each stage crops the semantic branch's maps
        (ROIAlign, 2 samples a bin) at the first ROI level's stride."""
        c = self.cfg
        sem_feat, sem_pred = self.semantic_branch(features[c.in_features[0]])
        scale = 1.0 / c.strides[0]

        def crop(full_map: torch.Tensor, res: int) -> torch.Tensor:
            return torch.cat([roi_align(full_map[i], boxes[i], res, scale)
                              for i in range(boxes.shape[0])])

        return self.mask_head(pooled, sem_feat, sem_pred, crop)

    def _mask_logits(self, features: Dict[str, torch.Tensor],
                     boxes: torch.Tensor) -> torch.Tensor:
        """The mask head's final logits (B·K, S, S) for boxes (B, K, 4)."""
        pooled = self._pool(features, boxes, self.cfg.mask_pooler_resolution)
        if self.refine:
            return compose_stage_preds(self._refine_stages(features, pooled, boxes))
        return self.mask_head(pooled)

    def _run_stage(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor, stage: int,
                   cls_inds: Optional[torch.Tensor] = None,
                   cap_classifier: Optional[torch.Tensor] = None):
        """ROIAlign + box head + predictor of one stage: boxes (B, P, 4) →
        (scores (B, P, C + 1 [+ N_cap]), deltas (B, P, 4)). The gradient into
        the pyramid is scaled by 1 / stages, as in the JAX package."""
        b, p = boxes.shape[:2]
        pooled = self._pool(features, boxes, self.cfg.pooler_resolution)
        pooled = _scale_gradient(pooled, 1.0 / self.num_stages)
        box_feat = getattr(self, f"box_head{stage}")(pooled)
        scores, deltas = getattr(self, f"box_predictor{stage}")(box_feat, cls_inds,
                                                                cap_classifier)
        return scores.reshape(b, p, -1), deltas.reshape(b, p, -1)

    def losses(self, rng: Rng, features: Dict[str, torch.Tensor],
               proposals: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
               fed_weight: Optional[torch.Tensor] = None,
               cls_inds: Optional[torch.Tensor] = None,
               image_sizes: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The cascade's training losses. proposals: boxes (B, P, 4), scores
        (B, P), valid (B, P); gt: boxes (B, N, 4), classes (B, N), valid
        (B, N), masks (B, N, S, S) in their own box frames and optionally
        instance_source (B, N); fed_weight (C,) the federated-loss class
        weights; cls_inds (K,) the dynamic classifier's columns; image_sizes
        (B, 2) to clip the boxes between stages. ``rng`` feeds the draws
        ``match``, ``mask`` and ``fed{stage}`` (module docstring)."""
        c = self.cfg
        if c.add_gt_to_proposals:
            pb = torch.cat([proposals["boxes"], gt["boxes"]], dim=1).float()
            pv = torch.cat([proposals["valid"], gt["valid"]], dim=1)
        else:
            pb, pv = proposals["boxes"].float(), proposals["valid"]
        b = pb.shape[0]
        gt_boxes = gt["boxes"].float()

        losses: Dict[str, torch.Tensor] = {}
        boxes = sample_valid = None
        for stage, iou_t in enumerate(c.cascade_ious):
            if stage == 0:
                # match, then subsample to batch_size_per_image
                r = uniform_draw(rng, "match", tuple(pv.shape), pb.device)
                picked = []
                for i in range(b):
                    midx, fg_i = match_proposals(pb[i], gt_boxes[i], gt["valid"][i], iou_t)
                    fg_i = fg_i & pv[i]
                    idx, ok = subsample_proposals(r[i], fg_i, pv[i], c.batch_size_per_image,
                                                  c.positive_fraction)
                    picked.append((pb[i][idx], midx[idx], fg_i[idx] & ok, ok))
                boxes, matched_idx, fg, sample_valid = (torch.stack(t) for t in zip(*picked))
            else:
                matched = [match_proposals(boxes[i], gt_boxes[i], gt["valid"][i], iou_t)
                           for i in range(b)]
                matched_idx, fg = (torch.stack(t) for t in zip(*matched))
                fg = fg & sample_valid

            gt_classes = torch.gather(gt["classes"].long(), 1, matched_idx)
            gt_classes = torch.where(fg, gt_classes, torch.full_like(gt_classes, c.num_classes))
            gt_boxes_m = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
            inst_src = None
            if "instance_source" in gt:
                inst_src = torch.gather(gt["instance_source"], 1, matched_idx)
                inst_src = torch.where(fg, inst_src, torch.zeros_like(inst_src))

            scores, deltas = self._run_stage(features, boxes, stage, cls_inds=cls_inds)
            stage_losses = _fast_rcnn_losses(c, rng, f"fed{stage}", scores, deltas, boxes,
                                             gt_classes, gt_boxes_m, sample_valid, inst_src,
                                             c.cascade_reg_weights[stage], fed_weight)
            losses.update({f"{k}_stage{stage}": v for k, v in stage_losses.items()})

            # the next stage's boxes carry no gradient; they are clipped to the
            # image, and boxes that became empty leave the loss
            refined = box_regression.apply_deltas(deltas.detach().float(), boxes,
                                                  c.cascade_reg_weights[stage])
            if image_sizes is not None:
                refined = box_ops.clip(refined, image_sizes)
                sample_valid = sample_valid & box_ops.nonempty(refined)
            boxes = refined

        if self.mask_head is not None:
            losses["loss_mask"] = c.mask_weight * self._mask_loss(rng, features, gt, proposals)
            if self.refine and "sem_seg" in gt:
                # the auxiliary semantic loss, its target resized (nearest) to the logits
                _, sem_logits = self.semantic_branch(features[c.in_features[0]])
                tgt = resize_nearest(gt["sem_seg"].float(), *sem_logits.shape[1:])
                losses["loss_semantic"] = c.sem_seg_weight * optax_sigmoid_bce(sem_logits,
                                                                               tgt).mean()
        return losses

    def _mask_loss(self, rng: Rng, features: Dict[str, torch.Tensor],
                   gt: Dict[str, torch.Tensor],
                   proposals: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The mask head trains on up to ``mask_fg_capacity`` foreground rows
        per image of the proposals with the ground truth appended, picked by
        the draw ``mask``."""
        c = self.cfg
        pb = torch.cat([proposals["boxes"], gt["boxes"]], dim=1).float()
        pv = torch.cat([proposals["valid"], gt["valid"]], dim=1)
        b = pb.shape[0]
        gt_boxes = gt["boxes"].float()
        cap = min(c.mask_fg_capacity, pb.shape[1])
        src = gt.get("instance_source")
        r = uniform_draw(rng, "mask", tuple(pv.shape), pb.device)
        picked = []
        for i in range(b):
            midx, fg_i = match_proposals(pb[i], gt_boxes[i], gt["valid"][i], c.cascade_ious[0])
            fg_i = fg_i & pv[i]
            if not c.divergen_mask_loss and src is not None:
                # ablation: only real (not pasted) instances train the mask head
                fg_i = fg_i & (src[i][midx] == 0)
            pri = torch.where(fg_i, r[i], torch.full_like(r[i], float("-inf")))
            topv, topi = stable_topk(pri, cap)
            picked.append((pb[i][topi], midx[topi], topv > float("-inf")))
        boxes, midx, ok = (torch.stack(t) for t in zip(*picked))

        # ground-truth masks are (N, S, S) crops in their own box frame: resample
        # each matched crop onto the proposal box at the head's resolution
        s = gt["masks"].shape[-1]
        crops = torch.gather(gt["masks"].float(), 1, midx[..., None, None].expand(-1, -1, s, s))
        src_boxes = torch.gather(gt_boxes, 1, midx[..., None].expand(-1, -1, 4))
        target = lambda res: (mask_target_in_box(crops, src_boxes, boxes, res) >= 0.5).float()
        pooled = self._pool(features, boxes, c.mask_pooler_resolution)
        if self.refine:
            # a target at every stage's size; the stage weights (i + 1) / stages
            stages = self._refine_stages(features, pooled, boxes)
            n = len(stages)
            return refine_cross_entropy(
                stages, [target(lg.shape[-1]).reshape(b * cap, *lg.shape[-2:]) for lg in stages],
                ok.reshape(-1), stage_weights=tuple((i + 1) / n for i in range(n)))
        logits = self.mask_head(pooled)
        out_res = logits.shape[-1]
        logits = logits.reshape(b, cap, out_res, out_res)
        tgt = target(out_res)
        per_roi = optax_sigmoid_bce(logits, tgt).mean(dim=(2, 3))
        total = torch.where(ok, per_roi, torch.zeros_like(per_roi)).sum()
        return total / ok.sum().clamp(min=1.0)

    def image_label_losses(self, features: Dict[str, torch.Tensor],
                           proposals: Dict[str, torch.Tensor], image_sizes: torch.Tensor,
                           labels: torch.Tensor, labels_valid: torch.Tensor,
                           ann_type: str = "image", cap_emb: Optional[torch.Tensor] = None,
                           cap_idx: Optional[torch.Tensor] = None,
                           cls_inds: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The weak losses of an image-labelled batch: labels (B, L) class ids
        with labels_valid (B, L); cap_emb (N_cap, zs_dim) caption embeddings
        with cap_idx (B,) each image's own column; cls_inds as in ``losses``.
        Each stage scores the clipped top proposals (``weak_proposals``), adds
        the caption loss on the last (image) box when captions are given and,
        unless ``ann_type`` is ``'caption'``, the image-label loss; the boxes
        move on to the next stage without a gradient. ``loss_cls_stage{k}``,
        ``loss_box_reg_stage{k}`` and ``loss_mask`` are zero."""
        c = self.cfg
        boxes, pvalid = weak_proposals(c, proposals, image_sizes)
        cap_classifier = None if cap_emb is None else cap_emb.t()
        losses: Dict[str, torch.Tensor] = {}
        zero = torch.zeros((), device=boxes.device)
        for stage in range(self.num_stages):
            scores, deltas = self._run_stage(features, boxes, stage, cls_inds=cls_inds,
                                             cap_classifier=cap_classifier)
            scores = scores.float()
            img_loss = zero
            if cap_emb is not None:
                n_cap = cap_emb.shape[0]
                cls_scores, cap_last = scores[..., :-n_cap], scores[:, -1, -n_cap:]
                tgt = F.one_hot(cap_idx.long(), n_cap).float()
                bce = optax_sigmoid_bce(cap_last, tgt)
                if c.sync_caption_batch:
                    per_img = (bce * tgt).sum(1) + c.neg_cap_weight * (bce * (1.0 - tgt)).sum(1)
                else:
                    per_img = bce.sum(1)
                img_loss = img_loss + c.caption_weight * per_img.mean()
            else:
                cls_scores = scores
            if ann_type != "caption":
                img_loss = img_loss + _weak_image_loss(c, cls_scores, None, boxes, pvalid,
                                                       labels, labels_valid)
            losses[f"image_loss_stage{stage}"] = img_loss * c.image_loss_weight
            losses[f"loss_cls_stage{stage}"] = zero
            losses[f"loss_box_reg_stage{stage}"] = zero
            boxes = box_regression.apply_deltas(deltas.detach().float(), boxes,
                                                c.cascade_reg_weights[stage])
            boxes = box_ops.clip(boxes, image_sizes)
        if self.mask_head is not None:
            losses["loss_mask"] = zero
        return losses

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
            mask_logits = self._mask_logits(features, dets["boxes"])
            dets["mask_logits"] = mask_logits.reshape(b, k, *mask_logits.shape[-2:])
        return dets


def weak_proposals(c: ROIHeadsConfig, proposals: Dict[str, torch.Tensor],
                   image_sizes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The proposals a weak loss scores: the first ``ws_num_props`` (already
    score-sorted), without gradient, clipped to the image, and with
    ``add_image_box`` one more box per image, centred and ``image_box_size``
    of its size. Returns (boxes (B, P, 4), valid (B, P))."""
    n = min(c.ws_num_props, proposals["boxes"].shape[1])
    boxes = box_ops.clip(proposals["boxes"][:, :n].detach().float(), image_sizes)
    valid = proposals["valid"][:, :n]
    if c.add_image_box:
        f = c.image_box_size
        h, w = image_sizes[:, 0].float(), image_sizes[:, 1].float()
        ib = torch.stack([w * (1 - f) / 2, h * (1 - f) / 2,
                          w * (1 - (1 - f) / 2), h * (1 - (1 - f) / 2)], dim=-1)
        boxes = torch.cat([boxes, ib[:, None, :]], dim=1)
        valid = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)
    return boxes, valid


def _weak_image_loss(c: ROIHeadsConfig, scores: torch.Tensor,
                     prop_score: Optional[torch.Tensor], boxes: torch.Tensor,
                     prop_valid: torch.Tensor, labels: torch.Tensor,
                     labels_valid: torch.Tensor) -> torch.Tensor:
    """One stage's image-label loss, over (B, L) labels at once: scores and
    prop_score (B, P, C + 1) float32 logits (prop_score None: the scores take
    its place), boxes (B, P, 4), prop_valid (B, P).

    ``max_size``: BCE at the largest valid proposal, the last one always left
    out (also when it is not an image box); ``max_score``: at the valid
    proposal scoring highest for the label; ``first``: at proposal 0;
    ``image``: at the last (image) box; ``min_loss``: at the valid proposal of
    the smallest summed BCE, picked without gradient; ``wsddn`` / ``wsod``:
    sigmoid(scores) weighted by a softmax over the proposals of the proposal
    scores (invalid ones at -1e30), summed, clipped to [1e-10, 1 - 1e-10],
    then the BCE averaged over the classes. ``softmax_weak_loss`` replaces
    the row's BCE by -log_softmax at the label. Each image averages its
    valid labels (at least one in the denominator); the batch averages the
    images."""
    b, p, c1 = scores.shape
    lab = labels.long()
    tgt = (lab[..., None] == torch.arange(c1, device=lab.device)).float()  # (B, L, C1)
    col = torch.where(lab < 0, lab + c1, lab).clamp(0, c1 - 1)  # the label's column
    n_lab = lab.shape[1]
    kind = c.image_label_loss
    if kind in ("wsddn", "wsod"):
        ps = scores if prop_score is None else prop_score
        logits_p = torch.where(prop_valid[..., None], ps, torch.full_like(ps, -1e30))
        img = (torch.sigmoid(scores) * torch.softmax(logits_p, dim=1)).sum(dim=1)
        img = img.clamp(1e-10, 1.0 - 1e-10)[:, None, :]  # (B, 1, C1)
        ll = -(tgt * torch.log(img) + (1 - tgt) * torch.log(1 - img)).mean(dim=-1)
    else:
        neg_inf = torch.tensor(float("-inf"), device=scores.device)
        if kind == "max_size":
            area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
            area = torch.where(prop_valid, area, neg_inf)
            area[:, -1] = float("-inf")
            ind = area.argmax(dim=1)[:, None].expand(b, n_lab)
        elif kind == "max_score":
            per_label = torch.gather(scores, 2, col[:, None, :].expand(b, p, n_lab))
            ind = torch.where(prop_valid[..., None], per_label, neg_inf).argmax(dim=1)
        elif kind == "first":
            ind = torch.zeros((b, n_lab), dtype=torch.long, device=scores.device)
        elif kind == "image":
            ind = torch.full((b, n_lab), p - 1, dtype=torch.long, device=scores.device)
        elif kind == "min_loss":
            per_row = optax_sigmoid_bce(scores.detach()[:, :, None, :],
                                        tgt[:, None, :, :].expand(b, p, n_lab, c1)).sum(-1)
            ind = torch.where(prop_valid[..., None], per_row, -neg_inf).argmin(dim=1)
        else:
            raise ValueError(f"unknown image_label_loss {kind}")
        row = torch.gather(scores, 1, ind[..., None].expand(b, n_lab, c1))  # (B, L, C1)
        if c.softmax_weak_loss:
            ll = -torch.gather(torch.log_softmax(row, dim=-1), 2, col[..., None])[..., 0]
        else:
            ll = optax_sigmoid_bce(row, tgt).sum(dim=-1)
    lv = labels_valid.bool()
    per_image = torch.where(lv, ll, torch.zeros_like(ll)).sum(dim=1)
    return (per_image / lv.float().sum(dim=1).clamp(min=1.0)).mean()


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


def _fast_rcnn_losses(c: ROIHeadsConfig, rng: Rng, draw_name: str, scores: torch.Tensor,
                      deltas: torch.Tensor, proposal_boxes: torch.Tensor,
                      gt_classes: torch.Tensor, gt_boxes: torch.Tensor, valid: torch.Tensor,
                      instance_source: Optional[torch.Tensor], reg_weights: Tuple[float, ...],
                      fed_weight: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``loss_cls`` (sigmoid CE over C columns with the federated class mask,
    over the valid rows) and ``loss_box_reg`` (class-agnostic, foreground
    rows) of one stage: scores (B, P, C + 1), deltas (B, P, 4), gt_classes
    (B, P) with background = C. With ``split_paste_loss`` also the CE split by
    whether a row matched a pasted instance, with ``per_paste_loss`` the
    ``aux_*`` per-row columns."""
    b, p, cp1 = scores.shape
    num_classes = cp1 - 1
    flat_scores = scores.reshape(-1, cp1).float()
    flat_classes = gt_classes.reshape(-1)
    flat_valid = valid.reshape(-1)
    n_valid = flat_valid.sum().clamp(min=1.0)

    # an id at or beyond the background column is an all-zero target
    target = F.one_hot(flat_classes.clamp(max=num_classes), cp1)[:, :num_classes].float()
    bce_nofed = optax_sigmoid_bce(flat_scores[:, :num_classes], target)
    bce = bce_nofed
    if c.use_fed_loss and fed_weight is not None:
        background = torch.full_like(flat_classes, num_classes)
        fed_mask = get_fed_loss_classes(rng, torch.where(flat_valid, flat_classes, background),
                                        flat_valid, num_classes, c.fed_loss_num_cat, fed_weight,
                                        draw_name=draw_name)
        bce = bce * fed_mask[None, :num_classes]
    bce = bce * flat_valid[:, None]
    loss_cls = bce.sum() / n_valid

    extra: Dict[str, torch.Tensor] = {}
    if instance_source is not None and (c.split_paste_loss or c.per_paste_loss):
        flat_src = instance_source.reshape(-1)
        is_paste = (flat_src > 0) & flat_valid
        zero = torch.zeros((), device=scores.device)
        if c.split_paste_loss:
            # the same per-row CE, split by source, with the shared normalizer
            row_ce = bce.sum(dim=-1)
            extra["loss_paste_ins"] = torch.where(is_paste, row_ce, zero).sum() / n_valid
            extra["loss_nopaste_ins"] = torch.where(~is_paste, row_ce, zero).sum() / n_valid
        if c.per_paste_loss:
            # raw (no federated mask) per-row CE columns of the pasted rows
            max_loss, max_class = bce_nofed.max(dim=-1)
            extra["aux_paste_row_loss"] = torch.where(is_paste, bce_nofed.sum(dim=-1),
                                                      zero).reshape(b, p)
            extra["aux_paste_row_max_class"] = torch.where(
                is_paste, max_class, torch.full_like(max_class, -1)).reshape(b, p)
            extra["aux_paste_row_max_loss"] = torch.where(is_paste, max_loss, zero).reshape(b, p)
            extra["aux_paste_row_id"] = torch.where(is_paste, flat_src,
                                                    torch.zeros_like(flat_src)).reshape(b, p)

    fg = (flat_classes >= 0) & (flat_classes < num_classes) & flat_valid
    if instance_source is not None and not c.divergen_box_loss:
        fg = fg & (instance_source.reshape(-1) == 0)
    flat_pb = proposal_boxes.reshape(-1, 4)
    flat_gb = gt_boxes.reshape(-1, 4)
    flat_deltas = deltas.reshape(-1, 4).float()
    # normalized by the element count of the foreground loss: 4·n_fg for
    # smooth-L1, n_fg for GIoU
    if c.box_reg_loss_type == "smooth_l1":
        gt_deltas = box_regression.get_deltas(flat_pb, flat_gb, reg_weights)
        reg = smooth_l1_loss(flat_deltas, gt_deltas, c.smooth_l1_beta).sum(dim=-1)
        denom = (fg.sum() * 4.0).clamp(min=1.0)
    else:
        reg = giou_loss_xyxy(box_regression.apply_deltas(flat_deltas, flat_pb, reg_weights),
                             flat_gb)
        denom = (fg.sum() * 1.0).clamp(min=1.0)
    loss_box = torch.where(fg, reg, torch.zeros_like(reg)).sum() / denom
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box, **extra}
