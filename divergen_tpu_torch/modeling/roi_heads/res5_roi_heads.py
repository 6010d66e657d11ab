"""C4-style ROI heads (torch): ROIAlign on one level, a res5 tower, one stage.

Counterpart of ``divergen_tpu/modeling/roi_heads/res5_roi_heads.py``
(``CustomRes5ROIHeads``): 14 × 14 ROIAlign crops (adaptive sampling) of the
first of ``ROI_HEADS.IN_FEATURES``, ``num_blocks`` bottleneck blocks (the
first strides 2, FrozenBN), a mean over the 7 × 7 map, then the single-stage
Detic output layers, matching, sampling and losses of ``cascade_heads``; the
mask head runs on the res5 map of the same rows. Children carry the flax
scope names (``res5_block0.conv1``, ``box_predictor.cls_score``,
``mask_head.deconv``, …). Training draws ``match`` (B, P + N) and ``fed0``
(C + 1,) through ``ops.losses.uniform_draw``. ``image_label_losses`` is the
weak branch: one stage of the image-label loss over the top proposals and the
optional image box, with the WSDDN proposal-score branch under
``with_softmax_prop``; captions are not read (the head builds no zero-shot
classifier), as in the JAX module.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...ops.losses import Rng, optax_sigmoid_bce, uniform_draw
from ...utils.comm import global_mean_count
from ...ops.roi_align import roi_align
from ...structures.masks import mask_target_in_box
from ..backbone.resnet import Bottleneck
from . import box_regression
from .cascade_heads import (DeticOutputLayers, MaskRCNNConvUpsampleHead, ROIHeadsConfig,
                            _fast_rcnn_inference_single, _fast_rcnn_losses, _weak_image_loss,
                            match_proposals, subsample_proposals, weak_proposals)


class Res5ROIHeads(nn.Module):
    """Single-stage heads over one pyramid level of ``in_channels``."""

    def __init__(self, cfg: ROIHeadsConfig, in_channels: int = 256, res5_channels: int = 2048,
                 num_blocks: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        kw = dict(dtype=dtype, device=device)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"res5_block{i}", Bottleneck(
                in_channels if i == 0 else res5_channels, res5_channels, res5_channels // 4,
                stride=2 if i == 0 else 1, **kw))
        self.box_predictor = DeticOutputLayers(
            res5_channels, c.num_classes, prior_prob=c.prior_prob,
            cls_agnostic=c.cls_agnostic_bbox_reg, use_sigmoid_ce=c.use_sigmoid_ce,
            with_softmax_prop=c.with_softmax_prop, **kw)
        self.mask_head = None
        if c.mask_on:
            self.mask_head = MaskRCNNConvUpsampleHead(res5_channels, c.mask_num_conv,
                                                      c.mask_conv_dim, **kw)

    def _res5_features(self, features: Dict[str, torch.Tensor],
                       boxes: torch.Tensor) -> torch.Tensor:
        """(B, P, 4) boxes → (B·P, 7, 7, C) res5 outputs."""
        c = self.cfg
        fmap = features[c.in_features[0]]
        x = torch.cat([roi_align(fmap[i], boxes[i], 2 * c.pooler_resolution,
                                 1.0 / c.strides[0], sampling_ratio=0)
                       for i in range(boxes.shape[0])])
        for i in range(self.num_blocks):
            x = getattr(self, f"res5_block{i}")(x)
        return x

    def losses(self, rng: Rng, features: Dict[str, torch.Tensor],
               proposals: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
               fed_weight: Optional[torch.Tensor] = None,
               cls_inds: Optional[torch.Tensor] = None,
               image_sizes: Optional[torch.Tensor] = None,
               group=None) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_box_reg`` and ``loss_mask`` of the sampled
        proposals (the ground truth appended); arguments as
        ``CascadeROIHeads.losses`` (``image_sizes`` is not needed: one stage
        refines no boxes), the normalizers over the ranks of ``group``."""
        c = self.cfg
        pb = torch.cat([proposals["boxes"], gt["boxes"]], dim=1).float()
        pv = torch.cat([proposals["valid"], gt["valid"]], dim=1)
        b = pb.shape[0]
        gt_boxes = gt["boxes"].float()
        r = uniform_draw(rng, "match", tuple(pv.shape), pb.device, per_image=True)
        picked = []
        for i in range(b):
            midx, fg_i = match_proposals(pb[i], gt_boxes[i], gt["valid"][i], c.cascade_ious[0])
            fg_i = fg_i & pv[i]
            idx, ok = subsample_proposals(r[i], fg_i, pv[i], c.batch_size_per_image,
                                          c.positive_fraction)
            picked.append((pb[i][idx], midx[idx], fg_i[idx] & ok, ok))
        boxes, matched_idx, fg, ok = (torch.stack(t) for t in zip(*picked))
        gt_classes = torch.gather(gt["classes"].long(), 1, matched_idx)
        gt_classes = torch.where(fg, gt_classes, torch.full_like(gt_classes, c.num_classes))
        gt_boxes_m = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))

        x = self._res5_features(features, boxes)
        scores, deltas = self.box_predictor(x.mean(dim=(1, 2)), cls_inds)
        p = boxes.shape[1]
        losses = dict(_fast_rcnn_losses(c, rng, "fed0", scores.reshape(b, p, -1),
                                        deltas.reshape(b, p, -1), boxes, gt_classes, gt_boxes_m,
                                        ok, None, c.cascade_reg_weights[0], fed_weight, group))
        if self.mask_head is not None:
            logits = self.mask_head(x)
            res = logits.shape[-1]
            s = gt["masks"].shape[-1]
            crops = torch.gather(gt["masks"].float(), 1,
                                 matched_idx[..., None, None].expand(-1, -1, s, s))
            tgt = (mask_target_in_box(crops, gt_boxes_m, boxes, res) >= 0.5).float()
            per_roi = optax_sigmoid_bce(logits.reshape(b, p, res, res), tgt).mean(dim=(2, 3))
            w = fg.float()
            losses["loss_mask"] = (per_roi * w).sum() / global_mean_count(w.sum(), group,
                                                                          floor=1.0)
        return losses

    def image_label_losses(self, features: Dict[str, torch.Tensor],
                           proposals: Dict[str, torch.Tensor], image_sizes: torch.Tensor,
                           labels: torch.Tensor, labels_valid: torch.Tensor,
                           ann_type: str = "image", cap_emb=None, cap_idx=None,
                           cls_inds=None) -> Dict[str, torch.Tensor]:
        """``image_loss`` of one stage over ``cascade_heads.weak_proposals``
        through the res5 tower, and ``loss_cls``, ``loss_box_reg`` (and
        ``loss_mask``) at zero; arguments as
        ``CascadeROIHeads.image_label_losses``. ``ann_type``, ``cap_emb``,
        ``cap_idx`` and ``cls_inds`` are not read, as in the JAX module."""
        c = self.cfg
        boxes, pvalid = weak_proposals(c, proposals, image_sizes)
        b, p = boxes.shape[:2]
        feat = self._res5_features(features, boxes).mean(dim=(1, 2))
        scores, _ = self.box_predictor(feat)
        prop = self.box_predictor.prop_score(feat)
        scores = scores.reshape(b, p, -1).float()
        if prop is not None:
            prop = prop.reshape(b, p, -1).float()
        img_loss = _weak_image_loss(c, scores, prop, boxes, pvalid, labels, labels_valid)
        zero = torch.zeros((), device=boxes.device)
        out = {"image_loss": img_loss * c.image_loss_weight, "loss_cls": zero,
               "loss_box_reg": zero}
        if self.mask_head is not None:
            out["loss_mask"] = zero
        return out

    @torch.no_grad()
    def inference(self, features: Dict[str, torch.Tensor], proposals: Dict[str, torch.Tensor],
                  image_sizes: torch.Tensor, return_logits: bool = False) -> Dict[str, torch.Tensor]:
        """Padded detections as ``CascadeROIHeads.inference`` returns them,
        ``mask_logits`` (B, K, 14, 14) with a mask head. ``return_logits`` is
        not read, as in the JAX module."""
        c = self.cfg
        boxes = proposals["boxes"].float()
        b, p = boxes.shape[:2]
        scores, deltas = self.box_predictor(self._res5_features(features, boxes).mean(dim=(1, 2)))
        scores = scores.reshape(b, p, -1).float()
        probs = torch.sigmoid(scores) if c.use_sigmoid_ce else torch.softmax(scores, dim=-1)
        if c.mult_proposal_score:
            probs = torch.sqrt(probs * proposals["scores"].float().clamp(min=0.0)[..., None])
        boxes = box_regression.apply_deltas(deltas.reshape(b, p, -1).float(), boxes,
                                            c.cascade_reg_weights[0])
        per_image = [_fast_rcnn_inference_single(c, boxes[i], probs[i, :, :-1],
                                                 proposals["valid"][i], image_sizes[i])
                     for i in range(b)]
        dets = {k: torch.stack([d[k] for d in per_image]) for k in per_image[0]}
        if self.mask_head is not None:
            k = dets["boxes"].shape[1]
            ml = self.mask_head(self._res5_features(features, dets["boxes"]))
            dets["mask_logits"] = ml.reshape(b, k, *ml.shape[-2:])
        return dets
