"""Box2BoxTransform: delta encode and decode.

Counterpart of ``divergen_tpu/modeling/roi_heads/box_regression.py``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

_SCALE_CLAMP = math.log(1000.0 / 16)


def get_deltas(src: torch.Tensor, target: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """Encode target boxes relative to src boxes (both (..., 4) XYXY)."""
    wx, wy, ww, wh = weights
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    sw = sw.clamp(min=1e-6)
    sh = sh.clamp(min=1e-6)
    dx = wx * (tcx - scx) / sw
    dy = wy * (tcy - scy) / sh
    dw = ww * torch.log(tw.clamp(min=1e-6) / sw)
    dh = wh * torch.log(th.clamp(min=1e-6) / sh)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """Decode deltas on boxes; dw and dh are clamped at log(1000/16)."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=_SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=_SCALE_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
