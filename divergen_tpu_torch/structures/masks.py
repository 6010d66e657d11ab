"""Mask utilities on dense ``(N, H, W)`` float or bool tensors.

Counterpart of ``divergen_tpu/structures/masks.py``: dense bitmasks with
static shapes; ROI-cropped mask targets come from bilinear sampling on a
regular grid (``crop_and_resize``) or, for ground-truth masks stored as crops
in their own box frame, from ``mask_target_in_box``. The sampling functions
take a leading batch of masks and boxes (the JAX package maps one pair at a
time with ``vmap``).
"""
from __future__ import annotations

import torch


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """Tight XYXY boxes around the nonzero region of each (H, W) mask; an
    empty mask gives (0, 0, 0, 0)."""
    n, h, w = masks.shape
    on = masks > 0.5
    ys = torch.arange(h, device=masks.device)[None, :, None].expand(n, h, w)
    xs = torch.arange(w, device=masks.device)[None, None, :].expand(n, h, w)
    big = torch.iinfo(torch.int32).max
    x1 = torch.where(on, xs, big).amin(dim=(1, 2))
    y1 = torch.where(on, ys, big).amin(dim=(1, 2))
    x2 = torch.where(on, xs, -1).amax(dim=(1, 2)) + 1
    y2 = torch.where(on, ys, -1).amax(dim=(1, 2)) + 1
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).float()
    return torch.where(on.any(dim=(1, 2))[:, None], boxes, torch.zeros_like(boxes))


def mask_areas(masks: torch.Tensor) -> torch.Tensor:
    """Pixel count per mask."""
    return (masks > 0.5).float().sum(dim=(1, 2))


def _bilinear_sample_2d(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (..., H, W) on the outer grid ``ys`` (..., A) × ``xs``
    (..., B) with zero padding → (..., A, B)."""
    h, w = img.shape[-2:]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = (ys - y0)[..., :, None], (xs - x0)[..., None, :]
    y0i, x0i = y0.long(), x0.long()

    def at(yi, xi):
        valid = ((yi >= 0) & (yi < h))[..., :, None] & ((xi >= 0) & (xi < w))[..., None, :]
        rows = torch.gather(img, -2, yi.clamp(0, h - 1)[..., :, None].expand(*yi.shape, w))
        vals = torch.gather(rows, -1, xi.clamp(0, w - 1)[..., None, :].expand(
            *yi.shape, xi.shape[-1]))
        return torch.where(valid, vals, torch.zeros_like(vals))

    top = at(y0i, x0i) * (1 - wx1) + at(y0i, x0i + 1) * wx1
    bot = at(y0i + 1, x0i) * (1 - wx1) + at(y0i + 1, x0i + 1) * wx1
    return top * (1 - wy1) + bot * wy1


def crop_and_resize(masks: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """Crop each (H, W) mask to its XYXY box and resize to (size, size)
    bilinearly, sampling at the centres of ``size`` bins (ROIAlign-style);
    output in [0, 1]. masks (N, H, W), boxes (N, 4) → (N, size, size)."""
    x1, y1, x2, y2 = (boxes[..., i:i + 1] for i in range(4))
    steps = torch.arange(size, dtype=torch.float32, device=boxes.device) + 0.5
    ys = y1 + steps * (y2 - y1) / size - 0.5
    xs = x1 + steps * (x2 - x1) / size - 0.5
    return _bilinear_sample_2d(masks.float(), ys, xs)


def mask_target_in_box(mask_crop: torch.Tensor, src_box: torch.Tensor, dst_box: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Resample box-frame mask crops onto other boxes' frames. ``mask_crop``
    (..., S, S) is a ground-truth mask normalized to ``src_box`` (..., 4); the
    result (..., size, size) is the mask target for ``dst_box`` (..., 4), a
    proposal: each output point maps from image coordinates to the source
    box's frame and is sampled bilinearly, zero outside the source box."""
    s = mask_crop.shape[-1]
    sx1, sy1, sx2, sy2 = (src_box[..., i:i + 1] for i in range(4))
    dx1, dy1, dx2, dy2 = (dst_box[..., i:i + 1] for i in range(4))
    sw = (sx2 - sx1).clamp(min=1e-6)
    sh = (sy2 - sy1).clamp(min=1e-6)
    steps = torch.arange(size, dtype=torch.float32, device=mask_crop.device) + 0.5
    ys_img = dy1 + steps * (dy2 - dy1) / size
    xs_img = dx1 + steps * (dx2 - dx1) / size
    my = (ys_img - sy1) / sh * s - 0.5
    mx = (xs_img - sx1) / sw * s - 0.5
    return _bilinear_sample_2d(mask_crop.float(), my, mx)
