"""CustomRCNN meta-architecture (torch): backbone + FPN + CenterNet + cascade heads.

Counterpart of ``divergen_tpu/modeling/meta_arch/rcnn.py``: one module whose
``forward`` takes a batched, padded image tensor and returns padded detections
(``training=False``) or the loss dict (``training=True`` with ground truth).
Children carry the flax scope names (``bottom_up``, ``fpn``,
``centernet_head``, ``roi_heads``).

Ported: the Swin backbone with the lateral FPN and ``DeticCascadeROIHeads``;
in training the box-supervised branch (``ann_type='box'``), ``gt_as_proposals``
and the dynamic classifier. Every other backbone name, ``fpn_kind='bifpn'``,
``CustomRes5ROIHeads``, ``CenterNetDetector`` and the weakly supervised
``ann_type``s raise ``NotImplementedError("… not yet ported")``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..backbone.fpn import FPN
from ..backbone.swin import SIZE2CONFIG, SwinTransformer
from ...ops.losses import Rng, sample_dynamic_classifier_inds
from ..centernet.centernet import (CenterNetConfig, CenterNetHead, centernet_ground_truth,
                                   centernet_losses, centernet_proposals, level_geometry)
from ..layers import set_param_dtype_
from ..roi_heads.cascade_heads import CascadeROIHeads, ROIHeadsConfig


class CustomRCNN(nn.Module):
    """End-to-end detector. ``compute_dtype`` is the dtype of the dense and
    conv weights and of the activations between them (bfloat16 with
    ``cfg.FP16``); norms, box decoding, scores and NMS run in float32.
    ``input_size`` is handed to ``SwinTransformer`` (the canvas the window
    sizes are built for, None when no window shrinks)."""

    def __init__(self, centernet_cfg: CenterNetConfig, roi_cfg: ROIHeadsConfig,
                 backbone_name: str = "swin",
                 fpn_in_features: Tuple[str, ...] = ("s3", "s4", "s5"),
                 fpn_out_channels: int = 256,
                 pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53),
                 pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375),
                 compute_dtype=torch.bfloat16, swin_size: str = "T",
                 roi_head_name: str = "DeticCascadeROIHeads", remat_backbone: bool = False,
                 fpn_kind: str = "fpn", dynamic_classifier: bool = False,
                 num_sample_cats: int = 50, dataset_loss_weight: Sequence[float] = (),
                 input_size: Optional[Tuple[int, int]] = None, device=None):
        super().__init__()
        if backbone_name != "swin":
            raise NotImplementedError(f"backbone {backbone_name!r} is not yet ported")
        if fpn_kind != "fpn":
            raise NotImplementedError(f"fpn_kind {fpn_kind!r} is not yet ported")
        if roi_head_name == "CustomRes5ROIHeads":
            raise NotImplementedError("CustomRes5ROIHeads is not yet ported")
        self.centernet_cfg, self.roi_cfg = centernet_cfg, roi_cfg
        self.compute_dtype = compute_dtype
        self.dynamic_classifier, self.num_sample_cats = dynamic_classifier, num_sample_cats
        self.dataset_loss_weight = tuple(dataset_loss_weight)
        kw = dict(dtype=compute_dtype, device=device)
        self.bottom_up = SwinTransformer.from_size(
            swin_size, remat=remat_backbone, input_size=input_size, **kw)
        embed = SIZE2CONFIG[swin_size][0]
        channels = [embed * 2 ** (int(f[-1]) - 2) for f in fpn_in_features]
        self.fpn = FPN(fpn_in_features, channels, fpn_out_channels, **kw)
        self.centernet_head = CenterNetHead(centernet_cfg, fpn_out_channels, **kw)
        self.roi_heads = CascadeROIHeads(roi_cfg, fpn_out_channels, **kw)
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, **f32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, **f32), persistent=False)

    def backbone_features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) RGB 0–255 float → the FPN maps p3..p7, NHWC."""
        x = ((images.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)
        return self.fpn(self.bottom_up(x))

    def _head_outputs(self, features: Dict[str, torch.Tensor]):
        """The CenterNet head over the pyramid, flattened over the levels:
        (geometry, agn_hm (B, M) logits, bbox_reg (B, M, 4)), float32."""
        cn_feats = [features[f] for f in self.centernet_cfg.in_features]
        agn_hms, bbox_regs, _ = self.centernet_head(cn_feats)
        shapes = tuple((f.shape[1], f.shape[2]) for f in cn_feats)
        geom = level_geometry(self.centernet_cfg, shapes, device=cn_feats[0].device)
        agn_flat = torch.cat([a.reshape(a.shape[0], -1) for a in agn_hms], dim=1).float()
        reg_flat = torch.cat([r.reshape(r.shape[0], -1, 4) for r in bbox_regs], dim=1).float()
        return geom, agn_flat, reg_flat

    def proposals(self, features: Dict[str, torch.Tensor],
                  image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The CenterNet head over the pyramid and the decoded proposals."""
        geom, agn_flat, reg_flat = self._head_outputs(features)
        return centernet_proposals(self.centernet_cfg, geom, agn_flat, reg_flat, image_sizes,
                                   training=False)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor, gt=None,
                rng: Optional[Rng] = None, fed_weight: Optional[torch.Tensor] = None,
                training: bool = False, gt_as_proposals: bool = False,
                return_logits: bool = False, ann_type: str = "box",
                dataset_source: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) RGB 0–255 float, image_sizes (B, 2) as (h, w).

        ``training=False``: padded detections (``CascadeROIHeads.inference``),
        without gradients. ``training=True``: the loss dict, from ``gt``
        (boxes (B, N, 4), classes (B, N), valid (B, N) bool, masks
        (B, N, S, S), instance_source (B, N)), ``rng`` (a ``torch.Generator``
        on the images' device, or a mapping of named draws:
        ``ops.losses.uniform_draw``) and optionally ``fed_weight`` (C,).
        DropPath stays off in training, as in the JAX package, whose backbone
        is called with its default ``deterministic=True``. ``gt_as_proposals``
        makes the ground-truth boxes the only proposals and returns the ROI
        losses alone."""
        if not training:
            if gt is not None:
                raise ValueError("ground truth was given with training=False")
            with torch.no_grad():
                features = self.backbone_features(images)
                proposals = self.proposals(features, image_sizes)
                return self.roi_heads.inference(features, proposals, image_sizes,
                                                return_logits=return_logits)
        if gt is None or rng is None:
            raise ValueError("the training forward needs gt and rng")
        if ann_type != "box":
            raise NotImplementedError(f"ann_type {ann_type!r} (weak supervision) is not yet ported")
        features = self.backbone_features(images)
        if gt_as_proposals:
            proposals = {"boxes": gt["boxes"], "valid": gt["valid"],
                         "scores": torch.ones(gt["boxes"].shape[:2], device=images.device)}
            return self.roi_heads.losses(rng, features, proposals, gt, fed_weight=fed_weight,
                                         image_sizes=image_sizes)
        geom, agn_flat, reg_flat = self._head_outputs(features)

        cls_inds = None
        if self.dynamic_classifier:
            # the zero-shot classifier scores K sampled columns this step, and
            # the targets move into that compact vocabulary
            cls_inds, cls_id_map = sample_dynamic_classifier_inds(
                rng, gt["classes"].reshape(-1), gt["valid"].reshape(-1),
                self.roi_cfg.num_classes, self.num_sample_cats, fed_weight)
            gt = dict(gt, classes=cls_id_map[gt["classes"].long()])
            if fed_weight is not None:
                fed_weight = fed_weight[cls_inds]

        reg_targets, heatmaps, pos_count = centernet_ground_truth(
            self.centernet_cfg, geom, gt["boxes"], gt["valid"])
        losses = centernet_losses(self.centernet_cfg, agn_flat, reg_flat, reg_targets, heatmaps,
                                  pos_count)
        # the proposals carry no gradient into the CenterNet head
        proposals = centernet_proposals(self.centernet_cfg, geom, agn_flat.detach(),
                                        reg_flat.detach(), image_sizes, training=True)
        losses.update(self.roi_heads.losses(rng, features, proposals, gt, fed_weight=fed_weight,
                                            cls_inds=cls_inds, image_sizes=image_sizes))
        return _apply_dataset_loss_weight(losses, self.dataset_loss_weight, dataset_source)


def _apply_dataset_loss_weight(losses, weights, dataset_source):
    """Per-dataset loss scaling: every batch comes from one dataset, so the
    scale is one pick from the static weight table."""
    if not weights or dataset_source is None:
        return losses
    return {k: v * weights[int(dataset_source)] for k, v in losses.items()}


def build_model(cfg, input_size: Optional[Tuple[int, int]] = None, device=None,
                param_dtype: Optional[torch.dtype] = None) -> CustomRCNN:
    """Assemble ``CustomRCNN`` from a ConfigNode, on ``device`` (default: the
    current default device). ``input_size`` as in ``CustomRCNN``.
    ``param_dtype=torch.float32`` stores the dense and conv parameters in
    float32 whatever the compute dtype, as a model that is to be trained needs
    (``modeling/layers.py``); left out, they are stored in the compute dtype.
    ``MODEL.SWIN.USE_CHECKPOINT`` turns on the rematerialization of the Swin
    blocks; ``MODEL.SWIN.FUSED_ATTN`` is not read: every window attention goes
    through the fused wrapper."""
    name = cfg.MODEL.BACKBONE.NAME
    if "swin" not in name.lower():
        raise NotImplementedError(f"backbone {name!r} is not yet ported (only Swin + FPN)")
    if "bifpn" in name.lower():
        raise NotImplementedError("the BiFPN neck is not yet ported")
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch != "CustomRCNN":
        raise NotImplementedError(f"meta-architecture {arch!r} is not yet ported")
    model = CustomRCNN(
        centernet_cfg=CenterNetConfig.from_cfg(cfg),
        roi_cfg=ROIHeadsConfig.from_cfg(cfg),
        backbone_name="swin",
        fpn_in_features=("s3", "s4", "s5"),
        fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        roi_head_name=cfg.MODEL.ROI_HEADS.NAME,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        compute_dtype=torch.bfloat16 if cfg.FP16 else torch.float32,
        swin_size=cfg.MODEL.SWIN.SIZE,
        remat_backbone=cfg.MODEL.SWIN.USE_CHECKPOINT,
        dynamic_classifier=cfg.MODEL.DYNAMIC_CLASSIFIER,
        num_sample_cats=cfg.MODEL.NUM_SAMPLE_CATS,
        dataset_loss_weight=tuple(cfg.MODEL.get("DATASET_LOSS_WEIGHT", [])),
        input_size=input_size,
        device=device,
    )
    return model if param_dtype is None else set_param_dtype_(model, param_dtype)


def load_zs_weight(path, zs_dim: Optional[int] = None) -> np.ndarray:
    """Load a zero-shot classifier ``.npy`` as (zs_dim, C) float32. Published
    files are stored (C, zs_dim) and are transposed; with ``zs_dim`` given, a
    file already stored (zs_dim, C) passes through, and the ambiguous square
    case is transposed."""
    w = np.asarray(np.load(path), np.float32)
    assert w.ndim == 2, f"zs classifier {path}: expected 2-D, got {w.shape}"
    if zs_dim is not None and w.shape[0] == zs_dim and w.shape[1] != zs_dim:
        return w
    return w.T


@torch.no_grad()
def reset_cls_test(model: CustomRCNN, zs_weight) -> CustomRCNN:
    """Swap the zero-shot classifier vocabulary at test time: every cascade
    stage's ``zs_weight`` becomes ``zs_weight`` (zs_dim, C). zs_dim must match;
    C may differ, and the heads' class count follows. The JAX function
    returns a new parameter tree; a module is updated in place and returned."""
    heads = model.roi_heads
    new_c = None
    for k in range(heads.num_stages):
        pred = getattr(heads, f"box_predictor{k}")
        if not pred.use_zeroshot_cls:
            raise ValueError("reset_cls_test needs the zero-shot classifier (USE_ZEROSHOT_CLS)")
        old = pred.zs_weight
        w = torch.as_tensor(np.asarray(zs_weight), dtype=old.dtype, device=old.device)
        assert w.shape[0] == old.shape[0], (tuple(old.shape), tuple(w.shape))
        pred.zs_weight = nn.Parameter(w.clone())
        pred.num_classes = new_c = w.shape[1]
    if new_c is not None:
        heads.cfg = dataclasses.replace(heads.cfg, num_classes=new_c)
        model.roi_cfg = heads.cfg
    return model
