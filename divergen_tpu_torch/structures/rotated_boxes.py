"""Rotated boxes (torch): (N, 5) tensors of (cx, cy, w, h, angle in degrees,
counter-clockwise).

Counterpart of ``divergen_tpu/structures/rotated_boxes.py`` (detectron2's
``RotatedBoxes`` as functions over plain tensors). The pairwise IoU, NMS and
ROIAlign live in ``ops/rotated.py`` and are re-exported here.
"""
from __future__ import annotations

import torch

from ..ops.rotated import nms_rotated, pairwise_iou_rotated  # noqa: F401 (re-exported)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 5) → (N,)."""
    return boxes[:, 2] * boxes[:, 3]


def normalize_angles(boxes: torch.Tensor) -> torch.Tensor:
    """Angles wrapped into [-180, 180)."""
    out = boxes.clone()
    out[:, 4] = torch.remainder(boxes[:, 4] + 180.0, 360.0) - 180.0
    return out


def clip(boxes: torch.Tensor, image_size, clip_angle_threshold: float = 1.0) -> torch.Tensor:
    """Clip the near-horizontal boxes (|normalized angle| <= threshold) to the
    image (h, w) as axis-aligned boxes, keeping their angle; the others are
    left as they are (clipping a rotated box to the frame is ill-defined)."""
    h = torch.as_tensor(image_size[0], dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(image_size[1], dtype=boxes.dtype, device=boxes.device)
    near = normalize_angles(boxes)[:, 4].abs() <= clip_angle_threshold
    lim = lambda v, hi: torch.minimum(v.clamp(min=0), hi)
    x1 = lim(boxes[:, 0] - boxes[:, 2] / 2, w)
    y1 = lim(boxes[:, 1] - boxes[:, 3] / 2, h)
    x2 = lim(boxes[:, 0] + boxes[:, 2] / 2, w)
    y2 = lim(boxes[:, 1] + boxes[:, 3] / 2, h)
    clipped = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1, boxes[:, 4]], dim=-1)
    return torch.where(near[:, None], clipped, boxes)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    return (boxes[:, 2] > threshold) & (boxes[:, 3] > threshold)


def inside_box(boxes: torch.Tensor, image_size, boundary_threshold: float = 0.0) -> torch.Tensor:
    """Whether each box's centre lies inside the image (h, w), widened by
    ``boundary_threshold``."""
    h, w = image_size[0], image_size[1]
    return ((boxes[:, 0] >= -boundary_threshold) & (boxes[:, 1] >= -boundary_threshold)
            & (boxes[:, 0] < w + boundary_threshold) & (boxes[:, 1] < h + boundary_threshold))


def xyxy_to_rotated(xyxy: torch.Tensor) -> torch.Tensor:
    """(N, 4) xyxy → (N, 5) boxes at angle 0."""
    cx = (xyxy[:, 0] + xyxy[:, 2]) / 2
    cy = (xyxy[:, 1] + xyxy[:, 3]) / 2
    return torch.stack([cx, cy, xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1],
                        torch.zeros_like(cx)], dim=-1)
