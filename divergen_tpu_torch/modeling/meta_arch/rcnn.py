"""CustomRCNN meta-architecture (torch): backbone + FPN + CenterNet + ROI heads.

Counterpart of ``divergen_tpu/modeling/meta_arch/rcnn.py``: one module whose
``forward`` takes a batched, padded image tensor and returns padded detections
(``training=False``) or the loss dict (``training=True`` with ground truth).
Children carry the flax scope names (``bottom_up``, ``fpn``,
``centernet_head``, ``roi_heads``).

Backbones by ``backbone_name``: ``swin``, ``resnet{D}``, ``res2net{D}``,
``convnext``, ``vitdet`` (its simple feature pyramid replaces the FPN) and
``dla34``; the neck is the lateral FPN or, with ``fpn_kind="bifpn"``, the
BiFPN; the ROI heads ``DeticCascadeROIHeads`` or ``CustomRes5ROIHeads``.
``CenterNetDetector`` is the standalone CenterNet: no ROI heads, classwise
losses and detections. In training ``ann_type`` picks the branch as in the
JAX module: ``'box'``, ``'prop'`` and ``'proptag'`` take the box losses;
every other type (``'image'``, ``'caption'``, ``'captiontag'``, …) is weak
supervision: the CenterNet losses kept at ``v * 0.0`` and the ROI heads'
``image_label_losses`` on ``gt["image_labels"]`` and, given ``cap_emb``, the
local caption bank. ``gt_as_proposals`` and the dynamic classifier (over the
image labels on a weak batch) are ported too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..backbone.bifpn import BiFPN
from ..backbone.convnext import ConvNeXt, SIZES as CONVNEXT_SIZES
from ..backbone.dla import DLA34, OUT_CHANNELS as DLA_CHANNELS
from ..backbone.fpn import FPN
from ..backbone.resnet import Res2Net, ResNet
from ..backbone.swin import SIZE2CONFIG, SwinTransformer
from ..backbone.vit import ViT, ViTDet
from ...ops.losses import Rng, sample_dynamic_classifier_inds
from ..centernet.centernet import (CenterNetConfig, CenterNetHead, centernet_detections,
                                   centernet_ground_truth, centernet_ground_truth_classwise,
                                   centernet_losses, centernet_losses_classwise,
                                   centernet_proposals, level_geometry)
from ..layers import flax_init_, set_param_dtype_
from ..roi_heads.cascade_heads import CascadeROIHeads, ROIHeadsConfig
from ..roi_heads.res5_roi_heads import Res5ROIHeads

VIT_SIZES = {
    "B": dict(dim=768, layers=12, heads=12, global_layers=(2, 5, 8, 11)),
    "L": dict(dim=1024, layers=24, heads=16, global_layers=(5, 11, 17, 23)),
    "T": dict(dim=192, layers=4, heads=3, global_layers=(1, 3), window=4),
}


def _bottom_up(backbone_name: str, fpn_in_features: Sequence[str], swin_size: str,
               backbone_norm: str, remat: bool, fpn_out_channels: int, input_size, kw):
    """(the bottom-up module, its channels at ``fpn_in_features``, or None for
    ViTDet, which emits the pyramid itself)."""
    level = lambda f: int(f[-1])
    if backbone_name == "swin":
        embed = SIZE2CONFIG[swin_size][0]
        body = SwinTransformer.from_size(swin_size, remat=remat, input_size=input_size, **kw)
        return body, [embed * 2 ** (level(f) - 2) for f in fpn_in_features]
    if backbone_name.startswith(("resnet", "res2net")):
        res2net = backbone_name.startswith("res2net")
        depth = int(backbone_name.replace("res2net" if res2net else "resnet", "") or 50)
        cls = Res2Net if res2net else ResNet
        body = cls(depth=depth, norm=backbone_norm, out_features=fpn_in_features, **kw)
        return body, [ResNet.out_channels(depth)[f] for f in fpn_in_features]
    if backbone_name == "convnext":
        size = swin_size.lower() if swin_size else "tiny"
        dims = CONVNEXT_SIZES[size][1]
        return ConvNeXt.from_size(size, **kw), [dims[level(f) - 2] for f in fpn_in_features]
    if backbone_name == "vitdet":
        if input_size is None:
            raise ValueError("ViTDet sizes its global layers' relative-position tables by the "
                             "canvas: build it with input_size")
        vit = ViT(input_hw=tuple(input_size), **VIT_SIZES[swin_size or "B"], **kw)
        return ViTDet(vit, fpn_out_channels, device=kw["device"]), None
    if backbone_name == "dla34":
        return DLA34(out_features=fpn_in_features, **kw), [DLA_CHANNELS[f] for f in fpn_in_features]
    raise ValueError(f"unknown backbone {backbone_name}")


class CustomRCNN(nn.Module):
    """End-to-end detector. ``compute_dtype`` is the dtype of the dense and
    conv weights and of the activations between them (bfloat16 with
    ``cfg.FP16``); norms, box decoding, scores and NMS run in float32.
    ``input_size`` is the canvas the window and relative-position tables are
    built for: Swin's shrunk windows (None when no window shrinks) and
    ViTDet's global layers (required there)."""

    builds_roi_heads = True

    def __init__(self, centernet_cfg: CenterNetConfig, roi_cfg: ROIHeadsConfig,
                 backbone_name: str = "swin",
                 fpn_in_features: Tuple[str, ...] = ("s3", "s4", "s5"),
                 fpn_out_channels: int = 256,
                 pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53),
                 pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375),
                 backbone_norm: str = "FrozenBN",
                 compute_dtype=torch.bfloat16, swin_size: str = "T",
                 roi_head_name: str = "DeticCascadeROIHeads", remat_backbone: bool = False,
                 fpn_kind: str = "fpn", num_bifpn: int = 3, dynamic_classifier: bool = False,
                 num_sample_cats: int = 50, dataset_loss_weight: Sequence[float] = (),
                 input_size: Optional[Tuple[int, int]] = None, device=None):
        super().__init__()
        self.centernet_cfg, self.roi_cfg = centernet_cfg, roi_cfg
        self.backbone_name, self.fpn_kind = backbone_name, fpn_kind
        self.compute_dtype = compute_dtype
        self.dynamic_classifier, self.num_sample_cats = dynamic_classifier, num_sample_cats
        self.dataset_loss_weight = tuple(dataset_loss_weight)
        kw = dict(dtype=compute_dtype, device=device)
        self.bottom_up, channels = _bottom_up(backbone_name, fpn_in_features, swin_size,
                                              backbone_norm, remat_backbone, fpn_out_channels,
                                              input_size, kw)
        if channels is None:
            self.fpn = None
        elif fpn_kind == "bifpn":
            self.fpn = BiFPN(fpn_in_features, channels, fpn_out_channels, num_bifpn, **kw)
        else:
            self.fpn = FPN(fpn_in_features, channels, fpn_out_channels, **kw)
        self.centernet_head = CenterNetHead(centernet_cfg, fpn_out_channels, **kw)
        if self.builds_roi_heads:
            heads = Res5ROIHeads if roi_head_name == "CustomRes5ROIHeads" else CascadeROIHeads
            self.roi_heads = heads(roi_cfg, fpn_out_channels, **kw)
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, **f32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, **f32), persistent=False)

    def backbone_features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) RGB 0–255 float → the FPN maps p3..p7, NHWC."""
        x = ((images.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)
        features = self.bottom_up(x)
        return features if self.fpn is None else self.fpn(features)

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
                cap_emb: Optional[torch.Tensor] = None,
                dataset_source: Optional[int] = None,
                axis_name: Optional[str] = None) -> Dict[str, torch.Tensor]:
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
        losses alone.

        Weak supervision (``ann_type`` not ``'box'``, ``'prop'`` or
        ``'proptag'``): ``gt`` also holds ``image_labels`` (B, L) and
        ``image_labels_valid`` (B, L) bool; ``cap_emb`` (B, zs_dim) is the
        batch's caption embeddings, image i's own caption at column i. The
        loss dict is the CenterNet losses times 0.0 updated with
        ``roi_heads.image_label_losses``. ``axis_name`` names a reduction
        over ranks (the JAX module's ``psum`` of the CenterNet positives and
        ``SYNC_CAPTION_BATCH``'s caption all-gather); it raises: several
        ranks wait for ``torch.distributed``."""
        if axis_name is not None:
            raise NotImplementedError(
                f"axis_name={axis_name!r}: reductions over ranks (the CenterNet positives, "
                "SYNC_CAPTION_BATCH's caption all-gather) wait for torch.distributed, "
                "ROADMAP.md §1 item 4; on one card pass axis_name=None")
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
        features = self.backbone_features(images)
        if gt_as_proposals:
            proposals = {"boxes": gt["boxes"], "valid": gt["valid"],
                         "scores": torch.ones(gt["boxes"].shape[:2], device=images.device)}
            return self.roi_heads.losses(rng, features, proposals, gt, fed_weight=fed_weight,
                                         image_sizes=image_sizes)
        geom, agn_flat, reg_flat = self._head_outputs(features)

        cls_inds = None
        if self.dynamic_classifier and ann_type != "caption":
            # the zero-shot classifier scores K sampled columns this step, and
            # the targets move into that compact vocabulary: the boxes' classes
            # on a box batch, the image labels (drawn without the frequency
            # weights) on any other
            key = "classes" if ann_type == "box" else "image_labels"
            ok = gt["valid"] if ann_type == "box" else gt["image_labels_valid"]
            cls_inds, cls_id_map = sample_dynamic_classifier_inds(
                rng, gt[key].reshape(-1), ok.reshape(-1), self.roi_cfg.num_classes,
                self.num_sample_cats, fed_weight if ann_type == "box" else None)
            gt = dict(gt, **{key: cls_id_map[gt[key].long()]})
            if fed_weight is not None:
                fed_weight = fed_weight[cls_inds]

        reg_targets, heatmaps, pos_count = centernet_ground_truth(
            self.centernet_cfg, geom, gt["boxes"], gt["valid"])
        losses = centernet_losses(self.centernet_cfg, agn_flat, reg_flat, reg_targets, heatmaps,
                                  pos_count)
        # the proposals carry no gradient into the CenterNet head
        proposals = centernet_proposals(self.centernet_cfg, geom, agn_flat.detach(),
                                        reg_flat.detach(), image_sizes, training=True)
        if ann_type not in ("box", "prop", "proptag"):
            # an image-labelled or captioned batch: no matching, the weak losses
            cap_idx = None
            if cap_emb is not None:
                cap_idx = torch.arange(cap_emb.shape[0], device=cap_emb.device)
            weak = self.roi_heads.image_label_losses(
                features, proposals, image_sizes, gt["image_labels"], gt["image_labels_valid"],
                ann_type=ann_type, cap_emb=cap_emb, cap_idx=cap_idx, cls_inds=cls_inds)
            losses = {k: v * 0.0 for k, v in losses.items()}
            losses.update(weak)
            return _apply_dataset_loss_weight(losses, self.dataset_loss_weight, dataset_source)
        losses.update(self.roi_heads.losses(rng, features, proposals, gt, fed_weight=fed_weight,
                                            cls_inds=cls_inds, image_sizes=image_sizes))
        return _apply_dataset_loss_weight(losses, self.dataset_loss_weight, dataset_source)


def _apply_dataset_loss_weight(losses, weights, dataset_source):
    """Per-dataset loss scaling: every batch comes from one dataset, so the
    scale is one pick from the static weight table."""
    if not weights or dataset_source is None:
        return losses
    return {k: v * weights[int(dataset_source)] for k, v in losses.items()}


class CenterNetDetector(CustomRCNN):
    """The standalone CenterNet (``only_proposal=False``): backbone → neck →
    classwise CenterNet head; no ROI heads are built, as the JAX init
    materializes none. Training returns the classwise losses, inference the
    class-aware NMS'd detections (boxes, scores, classes, valid)."""

    builds_roi_heads = False

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor, gt=None,
                rng: Optional[Rng] = None, training: bool = False,
                **_) -> Dict[str, torch.Tensor]:
        c = self.centernet_cfg
        if training and gt is None:
            raise ValueError("the training forward needs gt")
        with torch.set_grad_enabled(training and torch.is_grad_enabled()):
            features = self.backbone_features(images)
            cn_feats = [features[f] for f in c.in_features]
            agn_hms, bbox_regs, clss = self.centernet_head(cn_feats)
            geom = level_geometry(c, tuple((f.shape[1], f.shape[2]) for f in cn_feats),
                                  device=images.device)
            flat = lambda xs, *tail: torch.cat([x.reshape(x.shape[0], -1, *tail) for x in xs],
                                               dim=1).float()
            cls_flat, reg_flat = flat(clss, c.num_classes), flat(bbox_regs, 4)
            agn_flat = flat(agn_hms) if c.with_agn_hm else None
            if training:
                targets = centernet_ground_truth_classwise(c, geom, gt["boxes"], gt["classes"],
                                                           gt["valid"])
                reg_targets, hm_agn, hm_cls, pos_cls = targets
                return centernet_losses_classwise(c, cls_flat, agn_flat, reg_flat, reg_targets,
                                                  hm_agn, hm_cls, pos_cls)
            return centernet_detections(c, geom, cls_flat, agn_flat, reg_flat, image_sizes,
                                        training=False)


def _backbone_of(cfg) -> Tuple[str, Tuple[str, ...], str]:
    """(backbone name, neck input features, size) from ``MODEL.BACKBONE.NAME``,
    as the JAX ``build_model`` reads them: ``CONVNEXT_SIZE`` and ``VIT_SIZE``
    name the sizes, ``RESNETS.DEPTH`` the depth; ``RESNETS.STRIDE_IN_1X1``
    and ``MODEL.DLA.*`` are not read."""
    name = cfg.MODEL.BACKBONE.NAME.lower()
    if "swin" in name:
        return "swin", ("s3", "s4", "s5"), cfg.MODEL.SWIN.SIZE
    if "convnext" in name:
        return "convnext", ("c3", "c4", "c5"), cfg.MODEL.get("CONVNEXT_SIZE", "tiny")
    if "vit" in name:
        return "vitdet", ("p3", "p4", "p5"), cfg.MODEL.get("VIT_SIZE", "B")
    if "res2net" in name:
        return f"res2net{cfg.MODEL.RESNETS.DEPTH}", ("res3", "res4", "res5"), "T"
    if "dla" in name:
        return "dla34", ("dla3", "dla4", "dla5"), "T"
    return f"resnet{cfg.MODEL.RESNETS.DEPTH}", ("res3", "res4", "res5"), "T"


def build_model(cfg, input_size: Optional[Tuple[int, int]] = None, device=None,
                param_dtype: Optional[torch.dtype] = None) -> CustomRCNN:
    """Assemble ``CustomRCNN`` (or ``CenterNetDetector`` for that
    ``META_ARCHITECTURE``) from a ConfigNode, on ``device`` (default: the
    current default device). The backbone follows ``MODEL.BACKBONE.NAME``
    (``_backbone_of``); a name with ``bifpn`` takes the BiFPN neck of
    ``MODEL.BIFPN.OUT_CHANNELS`` and ``NUM_BIFPN``. ``input_size`` as in
    ``CustomRCNN``. ``param_dtype=torch.float32`` stores the dense and conv
    parameters in float32 whatever the compute dtype, as a model that is to
    be trained needs (``modeling/layers.py``); left out, they are stored in
    the compute dtype. ``MODEL.SWIN.USE_CHECKPOINT`` turns on the
    rematerialization of the Swin blocks; ``MODEL.SWIN.FUSED_ATTN`` is not
    read: every window attention goes through the fused wrapper."""
    backbone, fpn_in, size = _backbone_of(cfg)
    use_bifpn = "bifpn" in cfg.MODEL.BACKBONE.NAME.lower()
    cn_cfg = CenterNetConfig.from_cfg(cfg)
    arch = cfg.MODEL.META_ARCHITECTURE
    cls = CenterNetDetector if arch == "CenterNetDetector" else CustomRCNN
    if arch == "CenterNetDetector":
        cn_cfg = dataclasses.replace(cn_cfg, only_proposal=False)
    model = cls(
        centernet_cfg=cn_cfg,
        roi_cfg=ROIHeadsConfig.from_cfg(cfg),
        backbone_name=backbone,
        fpn_in_features=fpn_in,
        fpn_kind="bifpn" if use_bifpn else "fpn",
        num_bifpn=cfg.MODEL.BIFPN.NUM_BIFPN,
        fpn_out_channels=(cfg.MODEL.BIFPN.OUT_CHANNELS if use_bifpn
                          else cfg.MODEL.FPN.OUT_CHANNELS),
        roi_head_name=cfg.MODEL.ROI_HEADS.NAME,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        backbone_norm=cfg.MODEL.RESNETS.NORM,
        compute_dtype=torch.bfloat16 if cfg.FP16 else torch.float32,
        swin_size=size,
        remat_backbone=cfg.MODEL.SWIN.USE_CHECKPOINT,
        dynamic_classifier=cfg.MODEL.DYNAMIC_CLASSIFIER,
        num_sample_cats=cfg.MODEL.NUM_SAMPLE_CATS,
        dataset_loss_weight=tuple(cfg.MODEL.get("DATASET_LOSS_WEIGHT", [])),
        input_size=input_size,
        device=device,
    )
    return model if param_dtype is None else set_param_dtype_(model, param_dtype)


@torch.no_grad()
def detector_init_(model: CustomRCNN, gen: torch.Generator) -> CustomRCNN:
    """Random weights as the JAX detector's ``init`` draws them (not the same
    bits), for training from scratch: ``flax_init_`` everywhere, then the
    initializers the JAX heads name where they set a loss's scale at the
    start: the CenterNet head's convolutions normal(0.01), its heatmap and
    class-logit biases at the prior ``-log((1 - p) / p)`` and its box bias 8;
    each box predictor's classifier normal(0.01) with the prior bias (sigmoid
    CE), its box regressor and WSDDN proposal-score output normal(0.001); the
    mask predictor normal(0.001)."""
    flax_init_(model, gen)

    def normal_(w, std):
        w.copy_(torch.empty(w.shape, dtype=torch.float32, device=w.device)
                .normal_(0.0, std, generator=gen))

    prior = lambda p: -math.log((1 - p) / p)
    for name, mod in model.centernet_head.named_modules():
        if isinstance(mod, nn.Conv2d):
            normal_(mod.weight, 0.01)
            if mod.bias is not None:
                mod.bias.fill_(prior(model.centernet_cfg.prior_prob)
                               if name in ("agn_hm.conv", "cls_logits.conv")
                               else 8.0 if name == "bbox_pred.conv" else 0.0)
    heads = getattr(model, "roi_heads", None)
    if heads is None:
        return model
    bias = prior(heads.cfg.prior_prob) if heads.cfg.use_sigmoid_ce else 0.0
    preds = ([heads.box_predictor] if isinstance(heads, Res5ROIHeads)
             else [getattr(heads, f"box_predictor{k}") for k in range(heads.num_stages)])
    for pred in preds:
        if pred.use_zeroshot_cls:
            pred.bg_bias.fill_(bias)
        else:
            normal_(pred.cls_score.weight, 0.01)
            pred.cls_score.bias.fill_(bias)
        normal_(pred.bbox_pred.weight, 0.001)
        if pred.with_softmax_prop:
            normal_(pred.prop_score_out.weight, 0.001)
    if hasattr(heads.mask_head, "predictor"):
        normal_(heads.mask_head.predictor.weight, 0.001)
    return model


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
