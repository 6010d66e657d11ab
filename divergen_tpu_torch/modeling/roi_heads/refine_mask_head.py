"""RefineMask head (torch): multi-stage, boundary-refined mask prediction.

Counterpart of ``divergen_tpu/modeling/roi_heads/refine_mask_head.py``:

- ``generate_block_target``: a box filter marks the boundary band (1), the
  interior (2) and the rest (0) of a binary mask;
- ``SemanticBranch``: four 3×3 convs and 1×1 logits over the stride-8 level;
- ``MultiBranchFusion``: three dilated 3×3 convs (d = 1, 3, 5) summed, then a
  1×1 merge;
- ``SFMStage``: instance features, ROI crops of the transformed semantic
  features, the stage's instance mask and the ROI crop of the semantic mask,
  fused (1×1 → ``MultiBranchFusion`` → 1×1) and upsampled ×2 (half-pixel
  bilinear), the two masks re-appended at the new size;
- ``RefineMaskHead``: two instance convs, an ``SFMStage`` per supervision size
  but the last (channels halving), final 1×1 logits;
- ``refine_cross_entropy``: plain BCE up to ``start_stage``, then BCE on the
  union of the previous prediction's and target's boundary bands, with the
  running prediction composed as inference composes it
  (``compose_stage_preds``).

Resizes between stage sizes are bilinear with ``align_corners=True``
(``resize_align_corners``, one weight matrix per axis, as in the JAX
package). The stages' ROI crops come through a caller closure ``crop(map,
res)`` (``ops.roi_align`` at the semantic level's stride). Children carry the
flax scope names (``instance_conv0``, ``stage1.fuse_mbf.dilation_conv_2``,
``final_instance_logits``, ``semantic_branch.sem_logits``, …).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.losses import optax_sigmoid_bce
from ..layers import Conv, avg_pool, max_pool


def _align_corners_weights(out_n: int, in_n: int, device) -> torch.Tensor:
    if in_n == 1 or out_n == 1:
        return torch.full((out_n, in_n), 1.0 / in_n, device=device)
    src = torch.arange(out_n, dtype=torch.float32, device=device) * (in_n - 1) / (out_n - 1)
    lo = src.floor().to(torch.int64).clamp(0, in_n - 2)
    frac = src - lo.float()
    w = torch.zeros((out_n, in_n), device=device)
    rows = torch.arange(out_n, device=device)
    w.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    w.index_put_((rows, lo + 1), frac, accumulate=True)
    return w


def resize_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize with ``align_corners=True`` of the last two axes of a
    (..., H, W) tensor, in float32: rows, then columns, each one product with
    an (out, in) weight matrix."""
    wy = _align_corners_weights(oh, x.shape[-2], x.device)
    wx = _align_corners_weights(ow, x.shape[-1], x.device)
    y = torch.einsum("...hw,oh->...ow", x.float(), wy)
    return torch.einsum("...hw,ow->...ho", y, wx)


def generate_block_target(mask: torch.Tensor, boundary_width: int = 3) -> torch.Tensor:
    """(..., S, S) binary mask → int32 block target: 1 on the boundary band
    (pixels with at least a tenth of a (2w + 1)² window on the other side),
    2 on the interior, 0 elsewhere."""
    m = mask.float()
    k = 2 * boundary_width + 1
    flat = m.reshape((-1,) + tuple(m.shape[-2:]))[..., None]
    box = (avg_pool(flat, k, 1, boundary_width) * float(k * k))[..., 0].reshape(m.shape)
    pos = (k * k * m - box).clamp(min=0.0) / float(k * k) > 0.1
    neg = (k * k * (1.0 - m) - (k * k - box)).clamp(min=0.0) / float(k * k) > 0.1
    block = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    block = torch.where(pos | neg, torch.ones_like(block), block)
    return torch.where((m - pos.float()) > 0, torch.full_like(block, 2), block)


class SemanticBranch(nn.Module):
    """(B, H, W, C) → (features (B, H, W, conv_dim), logits (B, H, W) float32)."""

    def __init__(self, in_channels: int, conv_dim: int = 256, num_convs: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv(in_channels if i == 0 else conv_dim, conv_dim, 3,
                                             padding=1, dtype=dtype, device=device))
        self.sem_logits = Conv(conv_dim, 1, 1, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x, self.sem_logits(x)[..., 0]


class MultiBranchFusion(nn.Module):
    def __init__(self, feat_dim: int, dilations: Sequence[int] = (1, 3, 5), dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dilations = tuple(dilations)
        kw = dict(dtype=dtype, device=device)
        for i, d in enumerate(self.dilations):
            self.add_module(f"dilation_conv_{i + 1}", Conv(feat_dim, feat_dim, 3, padding=d,
                                                           dilation=d, **kw))
        self.merge_conv = Conv(feat_dim, feat_dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for i in range(len(self.dilations)):
            y = F.relu(getattr(self, f"dilation_conv_{i + 1}")(x))
            acc = y if acc is None else acc + y
        return self.merge_conv(acc)


def _pick_class(logits: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, s, s, K) logits → (N, s, s): the only channel, or each row's label's."""
    if logits.shape[-1] == 1:
        return logits[..., 0]
    lbl = (torch.zeros(logits.shape[0], dtype=torch.int64, device=logits.device)
           if labels is None else labels.long())
    return torch.gather(logits, -1, lbl[:, None, None, None].expand(*logits.shape[:3], 1))[..., 0]


class SFMStage(nn.Module):
    """One semantic fusion stage at ``out_size``: (N, s, s, Cin) instance
    features → (this stage's mask logits (N, s, s), features (N, 2s, 2s,
    Cout))."""

    def __init__(self, semantic_channels: int, instance_in_channel: int,
                 instance_out_channel: int, out_size: int, num_classes: int = 1,
                 mask_use_sigmoid: bool = True, dilations: Sequence[int] = (1, 3, 5),
                 dtype=torch.float32, device=None):
        super().__init__()
        cin = instance_in_channel
        self.out_size, self.mask_use_sigmoid, self.dtype = out_size, mask_use_sigmoid, dtype
        kw = dict(dtype=dtype, device=device)
        self.semantic_transform_in = Conv(semantic_channels, cin, 1, **kw)
        self.semantic_transform_out = Conv(cin, cin, 1, **kw)
        self.instance_logits = Conv(cin, num_classes, 1, dtype=torch.float32, device=device)
        self.fuse_conv_in = Conv(2 * cin + 2, cin, 1, **kw)
        self.fuse_mbf = MultiBranchFusion(cin, dilations, **kw)
        self.fuse_transform_out = Conv(cin, instance_out_channel - 2, 1, **kw)

    def forward(self, instance_feats: torch.Tensor, semantic_feat: torch.Tensor,
                semantic_pred: torch.Tensor, crop: Callable[[torch.Tensor, int], torch.Tensor],
                roi_labels: Optional[torch.Tensor] = None):
        s, dt = self.out_size, self.dtype
        sem_t = F.relu(self.semantic_transform_in(semantic_feat))
        ins_sem_feats = F.relu(self.semantic_transform_out(crop(sem_t, s)))
        instance_preds = _pick_class(self.instance_logits(instance_feats), roi_labels)
        ip = torch.sigmoid(instance_preds) if self.mask_use_sigmoid else instance_preds
        inst_masks = resize_align_corners(ip, s, s)[..., None].to(dt)
        sp = torch.sigmoid(semantic_pred) if self.mask_use_sigmoid else semantic_pred
        ins_sem = resize_align_corners(crop(sp[..., None], s)[..., 0], s, s)
        fused = torch.cat([instance_feats.to(dt), ins_sem_feats, inst_masks,
                           ins_sem[..., None].to(dt)], dim=-1)
        fused = F.relu(self.fuse_conv_in(fused))
        fused = F.relu(self.fuse_mbf(fused))
        fused = F.relu(self.fuse_transform_out(fused))
        # ×2 half-pixel bilinear (jax.image.resize "bilinear"), then ReLU
        fused = F.interpolate(fused.permute(0, 3, 1, 2), size=(2 * s, 2 * s), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        fused = F.relu(fused)
        im2 = resize_align_corners(ip, 2 * s, 2 * s)[..., None].to(dt)
        sm2 = resize_align_corners(ins_sem.to(dt), 2 * s, 2 * s)[..., None].to(dt)
        return instance_preds, torch.cat([fused, im2, sm2], dim=-1)


class RefineMaskHead(nn.Module):
    """Instance tower + ``SFMStage`` stack + final logits: one logits map
    per supervision size of ``stage_sup_size``. The ``SemanticBranch`` lives
    with the caller, which passes its outputs in."""

    def __init__(self, in_channels: int, semantic_channels: int, conv_dim: int = 256,
                 num_convs_instance: int = 2, stage_sup_size: Sequence[int] = (14, 28, 56, 112),
                 stage_num_classes: Sequence[int] = (1, 1, 1, 1), mask_use_sigmoid: bool = True,
                 dilations: Sequence[int] = (1, 3, 5), dtype=torch.float32, device=None):
        super().__init__()
        self.num_convs_instance = num_convs_instance
        self.stage_sup_size = tuple(stage_sup_size)
        kw = dict(dtype=dtype, device=device)
        for i in range(num_convs_instance):
            self.add_module(f"instance_conv{i}", Conv(in_channels if i == 0 else conv_dim,
                                                      conv_dim, 3, padding=1, **kw))
        ch = conv_dim
        for idx, s in enumerate(self.stage_sup_size[:-1]):
            self.add_module(f"stage{idx}", SFMStage(
                semantic_channels, ch, ch // 2, s, stage_num_classes[idx], mask_use_sigmoid,
                dilations, **kw))
            ch //= 2
        self.final_instance_logits = Conv(ch, stage_num_classes[-1], 1, dtype=torch.float32,
                                          device=device)

    @property
    def num_stages(self) -> int:
        return len(self.stage_sup_size) - 1

    def forward(self, inst_feats: torch.Tensor, semantic_feat: torch.Tensor,
                semantic_pred: torch.Tensor, crop: Callable[[torch.Tensor, int], torch.Tensor],
                roi_labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        x = inst_feats
        for i in range(self.num_convs_instance):
            x = F.relu(getattr(self, f"instance_conv{i}")(x))
        outs = []
        for idx in range(self.num_stages):
            preds, x = getattr(self, f"stage{idx}")(x, semantic_feat, semantic_pred, crop,
                                                    roi_labels)
            outs.append(preds)
        outs.append(_pick_class(self.final_instance_logits(x), roi_labels))
        return tuple(outs)


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.where(m, x, torch.zeros_like(x)).sum() / m.sum().clamp(min=1.0)


def refine_cross_entropy(stage_logits: Sequence[torch.Tensor],
                         stage_targets: Sequence[torch.Tensor], valid: torch.Tensor,
                         stage_weights: Sequence[float] = (0.25, 0.5, 0.75, 1.0),
                         boundary_width: int = 2, start_stage: int = 1) -> torch.Tensor:
    """The weighted sum over stages of the boundary-gated BCE: stage_logits
    and stage_targets (N, s_i, s_i) each, valid (N,) the rows that count."""
    total = torch.zeros((), dtype=torch.float32, device=valid.device)
    v1 = valid[:, None, None]
    pre_pred = None
    for idx, (lg, w) in enumerate(zip(stage_logits, stage_weights)):
        tgt = stage_targets[idx].float()
        s = lg.shape[-1]
        bce = optax_sigmoid_bce(lg.float(), tgt)
        if idx <= start_stage:
            total = total + w * _masked_mean(bce, v1.expand(bce.shape))
            pre_pred = torch.sigmoid(lg.detach()) >= 0.5
            continue
        pre = pre_pred.float()
        pre_b = generate_block_target(pre, boundary_width) == 1
        tgt_b = generate_block_target(stage_targets[idx - 1].float(), boundary_width) == 1
        region = resize_align_corners((pre_b | tgt_b).float(), s, s) >= 0.5
        total = total + w * _masked_mean(bce, region & v1.expand(region.shape))
        # the running prediction composed as inference composes it: outside
        # the width-1 boundary band the coarser stage's upsampled logits stay
        pre_b1 = resize_align_corners((generate_block_target(pre, 1) == 1).float(), s, s) >= 0.5
        prev_up = resize_align_corners(stage_logits[idx - 1].detach().float(), s, s)
        pre_pred = torch.sigmoid(torch.where(pre_b1, lg.detach().float(), prev_up)) >= 0.5
    return total


def compose_stage_preds(stage_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """Inference composition: from the second stage on, each finer stage keeps
    the coarser prediction's upsampled logits outside the coarser
    prediction's width-1 boundary band. Returns the final-size logits."""
    preds = [lg.float() for lg in stage_logits[1:]]
    cur = preds[0]
    for nxt in preds[1:]:
        s = nxt.shape[-1]
        band = generate_block_target((torch.sigmoid(cur) >= 0.5).float(), 1) != 1
        non_boundary = resize_align_corners(band.float(), s, s) >= 0.5
        cur = torch.where(non_boundary, resize_align_corners(cur, s, s), nxt)
    return cur


def boundary_weight_map(target: torch.Tensor, width: int = 1, weight: float = 2.0) -> torch.Tensor:
    """(..., S, S) binary target → per-pixel weights, ``weight`` on the band
    where a (2w + 1)² dilation and erosion differ, 1 elsewhere."""
    t = target.float()
    flat = t.reshape((-1,) + tuple(t.shape[-2:]))[..., None]
    k = 2 * width + 1
    dil = max_pool(flat, k, 1, width)
    ero = -max_pool(-flat, k, 1, width)
    boundary = ((dil - ero)[..., 0] > 0.5).reshape(t.shape)
    return torch.where(boundary, torch.full_like(t, weight), torch.ones_like(t))
