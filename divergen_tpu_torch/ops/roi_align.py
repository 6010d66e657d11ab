"""ROIAlign (v2, aligned) and the multi-level FPN pooler, without torchvision.

Counterpart of ``divergen_tpu/ops/roi_align.py``. Bilinear sampling is
separable, so ROIAlign of one roi is exactly ``A_y @ fmap @ A_xᵀ`` with dense
per-roi interpolation matrices ``A_y (out, H)`` and ``A_x (out, W)`` whose
rows are the bins' averaged bilinear weight profiles: two batched matrix
products instead of scattered reads, with the JAX package's casts (the
matrices and the intermediate in the feature dtype, sums in float32).

Semantics are ROIAlignV2 (``aligned=True``): half-pixel offset, a sampling
grid per bin (fixed ``sampling_ratio`` or adaptive counts), average-pooled,
zero contribution outside the feature map.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

# static cap on per-roi adaptive sample counts: bins at a roi's assigned level
# are 2-4 px; only the clamping at the coarsest and finest level exceeds that,
# and a clipped count only thins the samples of very large rois
_ADAPTIVE_S_MAX = 12


def _border_weights(pos: torch.Tensor, extent: int) -> torch.Tensor:
    """Bilinear weights (..., extent) of sample positions. As in torchvision's
    kernel, a sample farther than 1 px outside [0, extent) gets zero weight,
    and one within that band is clamped onto the border pixel with full
    weight."""
    inside = (pos >= -1.0) & (pos <= float(extent))
    pos_c = pos.clamp(0.0, float(extent - 1))
    grid = torch.arange(extent, dtype=torch.float32, device=pos.device)
    w = (1.0 - (pos_c[..., None] - grid).abs()).clamp(min=0.0)
    return w * inside[..., None]


def _interp_matrix(start: torch.Tensor, size: torch.Tensor, n_out: int, s: int,
                   extent: int) -> torch.Tensor:
    """Per-roi 1-D interpolation matrix (R, n_out, extent) for a fixed count
    of ``s`` samples per bin; start and size (R,) are in feature coordinates."""
    n_pts = n_out * s
    rel = (torch.arange(n_pts, dtype=torch.float32, device=start.device) + 0.5) / n_pts
    pos = start[:, None] + rel[None, :] * size[:, None]  # (R, n_pts)
    w = _border_weights(pos, extent)
    return w.reshape(-1, n_out, s, extent).mean(dim=2)


def _interp_matrix_adaptive(start: torch.Tensor, size: torch.Tensor, n_out: int,
                            counts: torch.Tensor, extent: int,
                            s_max: int = _ADAPTIVE_S_MAX) -> torch.Tensor:
    """Adaptive-count variant: bin i draws ``counts[r]`` samples at
    ``start + (i + (k + 0.5) / cnt) · bin``, as a static grid of ``s_max``
    samples with a validity mask."""
    dev = start.device
    bins = size / n_out
    i_idx = torch.arange(n_out, dtype=torch.float32, device=dev)
    k_idx = torch.arange(s_max, dtype=torch.float32, device=dev)
    cnt = counts.clamp(1, s_max).to(torch.float32)[:, None, None]  # (R, 1, 1)
    frac = (k_idx[None, None, :] + 0.5) / cnt  # (R, 1, S)
    pos = start[:, None, None] + (i_idx[None, :, None] + frac) * bins[:, None, None]
    valid = k_idx[None, None, :] < cnt
    w = _border_weights(pos, extent) * valid[..., None]  # (R, n_out, S, extent)
    return w.sum(dim=2) / cnt


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2,
              sample_counts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """ROIAlign on one feature map: features (H, W, C), boxes (N, 4) XYXY in
    image coordinates → (N, output_size, output_size, C).

    ``sampling_ratio`` is the fixed number of samples per bin side, 0 for the
    adaptive per-roi counts ``ceil(roi_size / output_size)``. ``sample_counts``
    are externally computed adaptive (y, x) counts: the FPN pooler passes the
    assigned level's counts to every level."""
    h, w, _ = features.shape
    boxes = boxes.float()
    x1 = boxes[:, 0] * spatial_scale - 0.5  # aligned=True: half a pixel
    y1 = boxes[:, 1] * spatial_scale - 0.5
    roi_w = ((boxes[:, 2] - boxes[:, 0]) * spatial_scale).clamp(min=1e-6)
    roi_h = ((boxes[:, 3] - boxes[:, 1]) * spatial_scale).clamp(min=1e-6)
    if sample_counts is None and sampling_ratio == 0:
        sample_counts = (torch.ceil(roi_h / output_size).to(torch.int32),
                         torch.ceil(roi_w / output_size).to(torch.int32))
    if sample_counts is not None:
        a_y = _interp_matrix_adaptive(y1, roi_h, output_size, sample_counts[0], h)
        a_x = _interp_matrix_adaptive(x1, roi_w, output_size, sample_counts[1], w)
    else:
        a_y = _interp_matrix(y1, roi_h, output_size, sampling_ratio, h)  # (R, out, H)
        a_x = _interp_matrix(x1, roi_w, output_size, sampling_ratio, w)  # (R, out, W)
    dt = features.dtype
    a_y, a_x = a_y.to(dt), a_x.to(dt)
    r, c = a_y.shape[0], features.shape[-1]
    # rows: contract H; then columns: batched contract W. A product in the
    # feature dtype accumulates in float32 and rounds once, as the JAX
    # package's does before its cast back to the feature dtype.
    t = (a_y.reshape(r * output_size, h) @ features.reshape(h, w * c)).reshape(r, output_size, w, c)
    return torch.einsum("rjw,riwc->rijc", a_x, t)


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                           canonical_box_size: float = 224.0,
                           canonical_level: int = 4) -> torch.Tensor:
    """FPN level assignment, as an index from 0 at ``min_level``."""
    areas = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    sqrt_area = torch.sqrt(areas.clamp(min=1e-9))
    lvl = torch.floor(canonical_level + torch.log2(sqrt_area / canonical_box_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int64) - min_level


def multilevel_roi_align(feature_maps: Sequence[torch.Tensor], strides: Sequence[int],
                         boxes: torch.Tensor, output_size: int) -> torch.Tensor:
    """ROIPooler: align each box on its assigned FPN level. feature_maps are
    (H_l, W_l, C) of one image, boxes (N, 4) → (N, out, out, C).

    Every box is aligned on every level with the adaptive sample counts of its
    assigned level, and the assigned level's result is selected: static
    shapes, as in the JAX package. Levels are pooled one at a time into the
    output, so only one level's intermediate is alive."""
    boxes = boxes.float()
    min_level = int(math.log2(strides[0]))
    levels = assign_boxes_to_levels(boxes, min_level, min_level + len(strides) - 1)
    sel_scale = 1.0 / torch.tensor(strides, dtype=torch.float32, device=boxes.device)[levels]
    rh = ((boxes[:, 3] - boxes[:, 1]) * sel_scale).clamp(min=1e-6)
    rw = ((boxes[:, 2] - boxes[:, 0]) * sel_scale).clamp(min=1e-6)
    counts = (torch.ceil(rh / output_size).to(torch.int32),
              torch.ceil(rw / output_size).to(torch.int32))
    out = None
    for lvl, (fm, st) in enumerate(zip(feature_maps, strides)):
        pooled = roi_align(fm, boxes, output_size, 1.0 / st, sample_counts=counts)
        if out is None:
            out = torch.zeros_like(pooled)
        out = torch.where((levels == lvl)[:, None, None, None], pooled, out)
    return out
