"""Box operations on ``(..., 4)`` XYXY tensors.

Counterpart of ``divergen_tpu/structures/boxes.py``: boxes are plain tensors
in absolute XYXY and every function is pure and broadcasts. Padded (invalid)
rows are handled by callers through validity masks; degenerate boxes have
zero area and zero IoU.
"""
from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of XYXY boxes, clamped at 0 for degenerate rows."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def clip(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip boxes to ``(h, w)`` image bounds. ``image_size`` is a pair of
    numbers, a (2,) tensor, or (B, 2) against boxes (B, N, 4)."""
    size = torch.as_tensor(image_size, device=boxes.device).to(boxes.dtype)
    h, w = size[..., 0], size[..., 1]
    if size.dim() > 0 and size.dim() == boxes.dim() - 1:
        h, w = h[..., None], w[..., None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Bool mask of boxes with both sides > threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def centers(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy) centers."""
    return (boxes[..., :2] + boxes[..., 2:]) / 2.0


def _pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, M) intersection areas between two box sets."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def _ratio(inter: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    return torch.where(inter > 0, inter / denom.clamp(min=1e-9), torch.zeros_like(inter))


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU matrix; degenerate or padded boxes get IoU 0."""
    inter = _pairwise_intersection(boxes1, boxes2)
    union = area(boxes1)[:, None] + area(boxes2)[None, :] - inter
    return _ratio(inter, union)


def pairwise_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, M) intersection over the area of boxes2."""
    inter = _pairwise_intersection(boxes1, boxes2)
    return _ratio(inter, area(boxes2)[None, :].expand_as(inter))


def matched_pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of aligned box lists."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return _ratio(inter, area(boxes1) + area(boxes2) - inter)


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """COCO XYWH → XYXY."""
    xy = boxes[..., :2]
    return torch.cat([xy, xy + boxes[..., 2:]], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """XYXY → COCO XYWH."""
    xy = boxes[..., :2]
    return torch.cat([xy, boxes[..., 2:] - xy], dim=-1)


def scale(boxes: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    """Scale box coordinates."""
    return torch.stack([boxes[..., 0] * scale_x, boxes[..., 1] * scale_y,
                        boxes[..., 2] * scale_x, boxes[..., 3] * scale_y], dim=-1)
