"""Rotated-box ops (torch): ROIAlignRotated, rotated IoU, rotated NMS.

Counterpart of ``divergen_tpu/ops/rotated.py``, plain torch on any device (no
Pallas kernel serves them in the JAX package either):
  * ``roi_align_rotated``: bilinear samples on each box's rotated grid,
    ``sampling_ratio``² a bin, averaged (detectron2's ROIAlignRotated with
    aligned coordinates, offset -0.5);
  * ``pairwise_iou_rotated``: Sutherland–Hodgman clipping of one box's
    corners by the other's four edges in fixed buffers of 8 vertices (the
    most a quadrilateral clipped by a quadrilateral has), then the shoelace
    area;
  * ``nms_rotated``: exact greedy NMS over the rotated IoU
    (``ops/nms.py:greedy_nms``).

Boxes are detectron2's ``RotatedBoxes``: (cx, cy, w, h, angle) with the angle
in degrees, counter-clockwise in y-down image coordinates.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .nms import greedy_nms

_CAP = 8  # |quad ∩ quad| has at most 8 vertices
_PAIRS = 1 << 20  # box pairs clipped at once by pairwise_iou_rotated


def _bilinear(fmap: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fmap (H, W, C) at continuous y, x (...) → (..., C); a sample outside
    (-1, H) × (-1, W) is 0, as ROIAlign's empty bins."""
    h, w, _ = fmap.shape
    inb = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y = y.clamp(0.0, h - 1.0)
    x = x.clamp(0.0, w - 1.0)
    y0, x0 = y.floor().long(), x.floor().long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    out = (fmap[y0, x0] * (1 - ly) * (1 - lx) + fmap[y0, x1] * (1 - ly) * lx
           + fmap[y1, x0] * ly * (1 - lx) + fmap[y1, x1] * ly * lx)
    return out * inb[..., None]


def roi_align_rotated(fmap: torch.Tensor, rois: torch.Tensor, resolution: int,
                      spatial_scale: float = 1.0, sampling_ratio: int = 2) -> torch.Tensor:
    """fmap (H, W, C), rois (N, 5) in image coordinates → (N, res, res, C)."""
    cx = rois[:, 0] * spatial_scale - 0.5
    cy = rois[:, 1] * spatial_scale - 0.5
    bh = (rois[:, 3] * spatial_scale).clamp(min=1e-6) / resolution
    bw = (rois[:, 2] * spatial_scale).clamp(min=1e-6) / resolution
    theta = rois[:, 4] * math.pi / 180.0
    s = sampling_ratio
    steps = (torch.arange(resolution * s, device=rois.device, dtype=rois.dtype) + 0.5) / s
    # sample offsets in the box's frame, centred on it: (N, P) each, P = res · s
    yy = steps * bh[:, None] - (bh * resolution)[:, None] / 2.0
    xx = steps * bw[:, None] - (bw * resolution)[:, None] / 2.0
    gy, gx = yy[:, :, None], xx[:, None, :]  # the (P, P) grid, "ij"
    cos_t, sin_t = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    rx = cx[:, None, None] + gx * cos_t + gy * sin_t
    ry = cy[:, None, None] - gx * sin_t + gy * cos_t
    vals = _bilinear(fmap, ry, rx)  # (N, P, P, C)
    n = rois.shape[0]
    return vals.reshape(n, resolution, s, resolution, s, -1).mean(dim=(2, 4))


def _rect_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) → (..., 4, 2) corners, counter-clockwise."""
    th = boxes[..., 4] * math.pi / 180.0
    cos_t, sin_t = torch.cos(th)[..., None], torch.sin(th)[..., None]
    unit = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=boxes.dtype, device=boxes.device)
    dx = unit * boxes[..., 2:3]
    dy = unit.roll(1) * boxes[..., 3:4]
    x = boxes[..., 0:1] + dx * cos_t + dy * sin_t
    y = boxes[..., 1:2] - dx * sin_t + dy * cos_t
    return torch.stack([x, y], dim=-1)


def _clip_by_edge(poly: torch.Tensor, n: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Sutherland–Hodgman step for a batch: poly (..., CAP, 2) holding n
    (...) counter-clockwise vertices, clipped to the half-plane left of the
    edge a → b (..., 2). Returns the new buffer and count; points past the
    buffer are dropped, the count is not capped."""
    cap = poly.shape[-2]
    idx = torch.arange(cap, device=poly.device)
    valid = idx < n[..., None]
    nxt = torch.where(idx + 1 < n[..., None], idx + 1, torch.zeros_like(idx))
    p1 = poly
    p2 = torch.gather(poly, -2, nxt[..., None].expand(poly.shape))
    e = (b - a)[..., None, :]
    a = a[..., None, :]
    side = lambda p: e[..., 0] * (p[..., 1] - a[..., 1]) - e[..., 1] * (p[..., 0] - a[..., 0])
    s1, s2 = side(p1), side(p2)
    in1, in2 = s1 >= 0, s2 >= 0
    denom = s1 - s2
    t = torch.where(denom.abs() > 1e-12,
                    s1 / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.zeros_like(denom))
    inter = p1 + t[..., None] * (p2 - p1)
    # per input edge up to two points, the crossing first, then p2 if inside
    emit = torch.stack([(in1 != in2) & valid, in2 & valid], dim=-1).flatten(-2)
    pts = torch.stack([inter, p2], dim=-2).flatten(-3, -2)  # (..., 2 CAP, 2)
    pos = emit.long().cumsum(-1) - 1
    slot = torch.where(emit & (pos < cap), pos, torch.full_like(pos, cap))
    out = poly.new_zeros(poly.shape[:-2] + (cap + 1, 2))
    out.scatter_(-2, slot[..., None].expand(pts.shape), pts)
    return out[..., :cap, :], emit.sum(-1)


def _poly_area(poly: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    cap = poly.shape[-2]
    idx = torch.arange(cap, device=poly.device)
    valid = idx < n[..., None]
    nxt = torch.where(idx + 1 < n[..., None], idx + 1, torch.zeros_like(idx))
    q = torch.gather(poly, -2, nxt[..., None].expand(poly.shape))
    cross = poly[..., 0] * q[..., 1] - q[..., 0] * poly[..., 1]
    return 0.5 * torch.where(valid, cross, torch.zeros_like(cross)).sum(-1).abs()


def _iou_pairs(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of boxes1 (N, 5) against boxes2 (M, 5), all N · M pairs at once."""
    c1 = _rect_corners(boxes1)[:, None].expand(-1, boxes2.shape[0], -1, -1)
    c2 = _rect_corners(boxes2)[None].expand(boxes1.shape[0], -1, -1, -1)
    poly = torch.cat([c1, c1.new_zeros(c1.shape[:-2] + (_CAP - 4, 2))], dim=-2)
    n = torch.full(c1.shape[:2], 4, dtype=torch.long, device=boxes1.device)
    for k in range(4):
        poly, n = _clip_by_edge(poly, n, c2[..., k, :], c2[..., (k + 1) % 4, :])
    inter = torch.where(n >= 3, _poly_area(poly, n), torch.zeros((), device=poly.device,
                                                                 dtype=poly.dtype))
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None]
    return inter / (a1 + a2 - inter).clamp(min=1e-9)


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5) × (M, 5) → (N, M) IoU, clipped in chunks of rows of at most
    ``_PAIRS`` pairs."""
    rows = max(1, _PAIRS // max(boxes2.shape[0], 1))
    if boxes1.shape[0] <= rows:
        return _iou_pairs(boxes1, boxes2)
    return torch.cat([_iou_pairs(boxes1[i: i + rows], boxes2)
                      for i in range(0, boxes1.shape[0], rows)])


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact greedy NMS over rotated IoU: boxes (N, 5), scores (N,) → a keep
    mask (N,) in input order; invalid rows are never kept and never
    suppress."""
    return greedy_nms(boxes, scores, iou_threshold, valid, pairwise_iou_rotated)
