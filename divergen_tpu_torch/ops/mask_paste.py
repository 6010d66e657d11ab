"""Paste predicted ROI masks into image-sized bitmasks.

Counterpart of ``divergen_tpu/ops/mask_paste.py``: one batched inverse
bilinear warp. For each output pixel the ROI mask is sampled at the
corresponding normalized coordinate, with zeros outside the mask.
"""
from __future__ import annotations

from typing import Tuple

import torch


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, image_size: Tuple[int, int],
                threshold: float = 0.5) -> torch.Tensor:
    """Paste (N, M, M) roi masks into (N, H, W) image masks: grid-sample with
    ``align_corners=False`` over the box extent, then threshold (a threshold
    below 0 returns the soft float mask)."""
    h, w = image_size
    n, mh, mw = masks.shape
    masks = masks.float()
    boxes = boxes.float()
    dev = masks.device
    ys_img = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs_img = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    x1, y1, x2, y2 = boxes.unbind(dim=-1)
    bw = (x2 - x1).clamp(min=1e-6)
    bh = (y2 - y1).clamp(min=1e-6)
    # normalized [0, 1] position inside the box → mask pixel coordinates
    my = (ys_img[None] - y1[:, None]) / bh[:, None] * mh - 0.5  # (N, H)
    mx = (xs_img[None] - x1[:, None]) / bw[:, None] * mw - 0.5  # (N, W)
    out = _bilinear(masks, my, mx)
    if threshold >= 0:
        return (out >= threshold).float()
    return out


def _bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample (N, h, w) images at the outer grid ys (N, H) × xs (N, W), zero
    padding outside."""
    n, h, w = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = (ys - y0)[:, :, None]
    lx = (xs - x0)[:, None, :]
    y0i = y0.long()
    x0i = x0.long()
    rows = torch.arange(n, device=img.device)[:, None, None]

    def take(yi, xi):
        valid = ((yi >= 0) & (yi < h))[:, :, None] & ((xi >= 0) & (xi < w))[:, None, :]
        v = img[rows, yi.clamp(0, h - 1)[:, :, None], xi.clamp(0, w - 1)[:, None, :]]
        return torch.where(valid, v, torch.zeros_like(v))

    top = take(y0i, x0i) * (1 - lx) + take(y0i, x0i + 1) * lx
    bot = take(y0i + 1, x0i) * (1 - lx) + take(y0i + 1, x0i + 1) * lx
    return top * (1 - ly) + bot * ly
