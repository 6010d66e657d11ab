"""Detection losses: heatmap focal, IoU-family box regression, federated CE.

Counterpart of ``divergen_tpu/ops/losses.py``, function for function. All take
explicit weight and mask tensors so that padded rows contribute zero.

Randomness. The JAX package draws its uniform arrays from ``jax.random`` keys;
PyTorch cannot reproduce those bits. Every function of the port that draws
takes its array from :func:`uniform_draw`, whose ``rng`` is either a
``torch.Generator`` on the device of the draw or a mapping from the draw's
name to an array made elsewhere (the tests hand in the arrays the JAX keys
produce). Everything after the draw is deterministic.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .nms import stable_topk

Rng = Union[torch.Generator, Mapping[str, torch.Tensor]]


def uniform_draw(rng: Rng, name: str, shape: Tuple[int, ...], device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` on ``device``: drawn from a generator (on
    the generator's own device, then moved), or looked up by ``name`` in a
    mapping of arrays drawn elsewhere."""
    if isinstance(rng, torch.Generator):
        u = torch.rand(shape, generator=rng, device=rng.device, dtype=torch.float32)
        return u.to(device)
    u = torch.as_tensor(rng[name], dtype=torch.float32).to(device)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"draw {name!r} has shape {tuple(u.shape)}, expected {tuple(shape)}")
    return u


def heatmap_focal_loss(logits: torch.Tensor, targets: torch.Tensor, pos_count: torch.Tensor,
                       alpha: float = 0.25, beta: float = 4.0, gamma: float = 2.0,
                       sigmoid_clamp: float = 1e-4,
                       ignore_high_fp: float = -1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary penalty-reduced focal loss on a gaussian-rendered heatmap:
    ``(pos_loss_sum, neg_loss_sum)``, not normalized. The negative term runs
    over every location (damped by ``(1 − target)^beta``, 0 at exact peaks);
    the positive term counts a location ``pos_count`` times (two ground-truth
    centres in one cell count twice)."""
    pred = torch.sigmoid(logits).clamp(sigmoid_clamp, 1 - sigmoid_clamp)
    neg_weights = torch.pow(1.0 - targets, beta)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, gamma)
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, gamma) * neg_weights
    if ignore_high_fp > 0:
        neg_loss = (pred < ignore_high_fp).to(pred.dtype) * neg_loss
    if alpha >= 0:
        pos_loss = alpha * pos_loss
        neg_loss = (1.0 - alpha) * neg_loss
    return -(pos_count.to(pred.dtype) * pos_loss).sum(), -neg_loss.sum()


def iou_loss(pred: torch.Tensor, target: torch.Tensor, weight: Optional[torch.Tensor] = None,
             loss_type: str = "giou", reduction: str = "sum") -> torch.Tensor:
    """IoU-family loss on (N, 4) non-negative (left, top, right, bottom)
    distances from a centre point, with the reference's +1 smoothing of
    numerator and denominator and no clamp on the intersection terms."""
    pl, pt, pr, pb = pred.unbind(dim=1)
    tl, tt, tr, tb = target.unbind(dim=1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_inter = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_inter = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    inter = w_inter * h_inter
    union = target_area + pred_area - inter
    ious = (inter + 1.0) / (union + 1.0)
    if loss_type == "iou":
        losses = -torch.log(ious)
    elif loss_type == "linear_iou":
        losses = 1.0 - ious
    elif loss_type == "giou":
        ac_union = g_w * g_h
        gious = ious - (ac_union - union) / torch.where(ac_union == 0, torch.ones_like(ac_union),
                                                        ac_union)
        losses = 1.0 - gious
    else:
        raise ValueError(loss_type)
    if weight is not None:
        losses = losses * weight
    if reduction == "sum":
        return losses.sum()
    if reduction == "mean":
        return losses.mean()
    return losses


def giou_loss_xyxy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU loss on XYXY boxes."""
    px1, py1, px2, py2 = pred.unbind(dim=-1)
    tx1, ty1, tx2, ty2 = target.unbind(dim=-1)
    pa = (px2 - px1) * (py2 - py1)
    ta = (tx2 - tx1) * (ty2 - ty1)
    inter = ((torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0)
             * (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0))
    union = pa + ta - inter
    iou = inter / union.clamp(min=1e-7)
    carea = ((torch.maximum(px2, tx2) - torch.minimum(px1, tx1))
             * (torch.maximum(py2, ty2) - torch.minimum(py1, ty1))).clamp(min=1e-7)
    return 1.0 - (iou - (carea - union) / carea)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth-L1; ``beta`` 0 is plain L1."""
    diff = (pred - target).abs()
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _appeared(gt_classes: torch.Tensor, gt_valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(num_classes + 1,) bool: classes of the valid rows; invalid rows mark
    the background slot. A class id beyond the background slot marks nothing
    (the JAX package's out-of-range scatter is dropped): under the dynamic
    classifier background rows keep the full vocabulary's background id."""
    appeared = torch.zeros(num_classes + 2, dtype=torch.bool, device=gt_classes.device)
    index = torch.where(gt_valid, gt_classes, torch.full_like(gt_classes, num_classes)).long()
    appeared[index.clamp(max=num_classes + 1)] = True
    return appeared[:num_classes + 1]


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def get_fed_loss_classes(rng: Rng, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                         num_classes: int, num_sample_cats: int, freq_weight: torch.Tensor,
                         draw_name: str = "fed") -> torch.Tensor:
    """Federated-loss class mask, (num_classes + 1,) float32: 1 for every
    ground-truth class and for negatives sampled without replacement in
    proportion to ``freq_weight`` (Gumbel top-k on the draw ``draw_name`` of
    shape (num_classes + 1,)) until ``num_sample_cats`` classes are in."""
    appeared = _appeared(gt_classes, gt_valid, num_classes)
    prob = torch.cat([freq_weight, freq_weight.new_zeros(1)])
    prob = torch.where(appeared, torch.zeros_like(prob), prob)
    need = (num_sample_cats - appeared.sum()).clamp(min=0)
    gumbel = _gumbel(uniform_draw(rng, draw_name, tuple(prob.shape), prob.device))
    scores = torch.where(prob > 0, torch.log(prob + 1e-20) + gumbel,
                         torch.full_like(prob, float("-inf")))
    _, top_idx = stable_topk(scores, num_sample_cats)
    keep = torch.arange(num_sample_cats, device=prob.device) < need
    sampled = torch.zeros_like(appeared)
    sampled[top_idx] = keep
    sampled = sampled & (prob > 0)
    return (appeared | sampled).float()


def sample_dynamic_classifier_inds(rng: Rng, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                                   num_classes: int, num_sample_cats: int,
                                   freq_weight: Optional[torch.Tensor] = None,
                                   draw_name: str = "dyn"):
    """Dynamic classifier sampling: ``num_sample_cats`` classifier columns,
    every class of the batch first and then frequency-weighted random
    negatives (the draw ``draw_name`` of shape (num_classes,)). Returns
    ``(inds (K,), cls_id_map (C + 1,))``; the map sends original ids to compact
    ids and everything else, the background C included, to K."""
    dev = gt_classes.device
    appeared = _appeared(gt_classes, gt_valid, num_classes)[:num_classes]
    w = freq_weight if freq_weight is not None else torch.ones(num_classes, device=dev)
    gumbel = _gumbel(uniform_draw(rng, draw_name, (num_classes,), dev))
    score = torch.where(w > 0, torch.log(w + 1e-20) + gumbel, torch.full_like(gumbel, -1e30))
    score = torch.where(appeared, torch.full_like(score, float("inf")), score)
    _, inds = stable_topk(score, num_sample_cats)
    cls_id_map = torch.full((num_classes + 1,), num_sample_cats, dtype=torch.int64, device=dev)
    cls_id_map[inds] = torch.arange(num_sample_cats, device=dev)
    cls_id_map[num_classes] = num_sample_cats
    return inds, cls_id_map


def sigmoid_cross_entropy_with_fed_loss(scores: torch.Tensor, gt_classes: torch.Tensor,
                                        gt_valid: torch.Tensor, num_classes: int,
                                        fed_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Detic's one-vs-all sigmoid CE over C columns (background rows get an
    all-zero target), normalized by the number of valid rows, with the
    federated class mask zeroing classes that were not sampled."""
    index = torch.where(gt_valid, gt_classes, torch.full_like(gt_classes, num_classes)).long()
    target = F.one_hot(index.clamp(max=num_classes), num_classes + 1)[:, :num_classes].to(scores.dtype)
    bce = optax_sigmoid_bce(scores, target)
    if fed_mask is not None:
        bce = bce * fed_mask[None, :num_classes]
    bce = bce * gt_valid[:, None]
    return bce.sum() / gt_valid.sum().clamp(min=1.0)


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid BCE."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
