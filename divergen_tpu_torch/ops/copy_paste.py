"""Copy-paste compositor on the device (batched plain torch).

Counterpart of ``divergen_tpu/ops/copy_paste.py``: the host only decodes RGBA
patches; placement, scaling, blending, occlusion updates and bbox
recomputation run on the device with static shapes. No hand-written kernel is
involved on either side: the JAX functions are vmapped XLA image ops, these
are the same ops with the vmap written out as a leading batch dimension.
Every public function takes one sample, as its JAX twin does, or a batch of
samples with one more leading dimension on every argument.

Semantics (as in the JAX package):
- Pastes compose sequentially: later patches occlude earlier ones and the dst
  instances.
- Every output pixel inverse-warps into patch space and samples bilinearly,
  instead of resizing each patch to its box.
- Blend modes: ``basic`` (hard mask), ``alpha`` (alpha matte), ``gaussian``
  (5x5 box-blur feathered mask).
- The occluded-object filter (bbox moved ≤ ``bbox_occluded_thr`` on every
  coordinate or remaining mask > ``mask_occluded_thr`` px) is applied once
  after all pastes against the pre-paste boxes.

Masks are ``alpha > 128/255`` on bilinear samples, so the interpolation keeps
the JAX order of float32 operations: a pixel that sits on the threshold could
flip under another order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

MASK_THRESHOLD = 128.0 / 255.0  # alpha cut


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=like.device)


def _rasterize(patches: torch.Tensor, boxes: torch.Tensor, out_hw: Tuple[int, int],
               flip: Optional[torch.Tensor], angle: Optional[torch.Tensor]):
    """patches (L, ph, pw, 4), boxes (L, 4) → rgb (L, H, W, 3), alpha (L, H, W)."""
    h, w = out_hw
    n, ph, pw, ch = patches.shape
    x1, y1, x2, y2 = (boxes[:, i, None] for i in range(4))
    bw = (x2 - x1).clamp_min(1e-6)
    bh = (y2 - y1).clamp_min(1e-6)
    ys = (_arange(h, boxes) + 0.5 - y1) / bh  # (L, H), 0..1 inside the box
    xs = (_arange(w, boxes) + 0.5 - x1) / bw  # (L, W)
    if flip is not None:
        xs = torch.where(flip[:, None], 1.0 - xs, xs)
    lanes = torch.arange(n, device=patches.device)
    if angle is not None:
        # rotated grid: full 2D sample coordinates
        ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
        u = xs[:, None, :] - 0.5
        v = ys[:, :, None] - 0.5
        xg = ca * u + sa * v + 0.5  # rotate the sample grid (inverse warp)
        yg = -sa * u + ca * v + 0.5
        py = yg * ph - 0.5
        px = xg * pw - 0.5
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = (py - y0)[..., None], (px - x0)[..., None]
        y0i = y0.to(torch.int64).clamp(0, ph - 1)
        y1i = (y0i + 1).clamp(0, ph - 1)
        x0i = x0.to(torch.int64).clamp(0, pw - 1)
        x1i = (x0i + 1).clamp(0, pw - 1)
        flat = patches.reshape(n, ph * pw, ch)

        def gather(yi, xi):
            return flat[lanes[:, None], (yi * pw + xi).reshape(n, -1)].reshape(n, h, w, ch)

        top = gather(y0i, x0i) * (1 - lx) + gather(y0i, x1i) * lx
        bot = gather(y1i, x0i) * (1 - lx) + gather(y1i, x1i) * lx
        out = top * (1 - ly) + bot * ly
        inside = (yg >= 0) & (yg < 1) & (xg >= 0) & (xg < 1)
    else:
        # axis-aligned path: separable row and column indices
        py = ys * ph - 0.5
        px = xs * pw - 0.5
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = (py - y0)[:, :, None, None], (px - x0)[:, None, :, None]
        y0i = y0.to(torch.int64).clamp(0, ph - 1)
        y1i = (y0i + 1).clamp(0, ph - 1)
        x0i = x0.to(torch.int64).clamp(0, pw - 1)
        x1i = (x0i + 1).clamp(0, pw - 1)

        def gather(yi, xi):
            return patches[lanes[:, None, None], yi[:, :, None], xi[:, None, :]]

        top = gather(y0i, x0i) * (1 - lx) + gather(y0i, x1i) * lx
        bot = gather(y1i, x0i) * (1 - lx) + gather(y1i, x1i) * lx
        out = top * (1 - ly) + bot * ly
        inside = ((ys >= 0) & (ys < 1))[:, :, None] & ((xs >= 0) & (xs < 1))[:, None, :]
    alpha = torch.where(inside, out[..., 3], torch.zeros((), device=out.device))
    return out[..., :3], alpha


def rasterize_patch(patch: torch.Tensor, tgt_box: torch.Tensor, out_hw: Tuple[int, int],
                    flip: Optional[torch.Tensor] = None,
                    angle: Optional[torch.Tensor] = None):
    """Inverse-warp a patch (ph, pw, 4; rgb 0..255, alpha 0..1) into a
    full-frame layer: (rgb (H, W, 3), alpha (H, W)), alpha 0 outside
    ``tgt_box`` (x1, y1, x2, y2). ``flip`` mirrors horizontally; ``angle``
    (radians) rotates about the box center."""
    one = lambda t: None if t is None else torch.as_tensor(t, device=patch.device)[None]
    rgb, alpha = _rasterize(patch[None], tgt_box[None], out_hw, one(flip), one(angle))
    return rgb[0], alpha[0]


def _box_blur_5x5(x: torch.Tensor) -> torch.Tensor:
    """Separable 5x5 box filter with a zero border over the last two dims."""
    h, w = x.shape[-2:]
    a = torch.nn.functional.pad(x, (0, 0, 2, 2))
    a = sum(a[..., i: i + h, :] * 0.2 for i in range(5))
    a = torch.nn.functional.pad(a, (2, 2))
    return sum(a[..., i: i + w] * 0.2 for i in range(5))


def boxes_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """(..., N, H, W) bool → (..., N, 4) x1, y1, x2+1, y2+1. An empty mask
    gives a zero box."""
    h, w = masks.shape[-2:]
    x_any = masks.any(dim=-2)  # (..., N, W)
    y_any = masks.any(dim=-1)  # (..., N, H)
    xs, ys = _arange(w, masks), _arange(h, masks)
    big = torch.tensor(1e9, device=masks.device)
    x1 = torch.where(x_any, xs, big).amin(-1)
    x2 = torch.where(x_any, xs, -big).amax(-1) + 1
    y1 = torch.where(y_any, ys, big).amin(-1)
    y2 = torch.where(y_any, ys, -big).amax(-1) + 1
    empty = ~x_any.any(dim=-1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    return torch.where(empty[..., None], torch.zeros((), device=masks.device), boxes)


def _layers(image, patches, patch_boxes, patch_valid, patch_flip, patch_angle):
    """Rasterize all P layers of every sample at once and resolve occlusion in
    one pass: patch k's final mask is bins[k] minus the union of later
    patches. Returns rgbs (B, P, H, W, 3), alphas, bins, occ_after (B, P, H, W)."""
    b, h, w, _ = image.shape
    p = patches.shape[1]
    flat = lambda t: None if t is None else t.reshape(b * p, *t.shape[2:])
    rgbs, alphas = _rasterize(flat(patches), flat(patch_boxes), (h, w), flat(patch_flip),
                              flat(patch_angle))
    rgbs, alphas = rgbs.reshape(b, p, h, w, 3), alphas.reshape(b, p, h, w)
    bins = (alphas > MASK_THRESHOLD) & patch_valid[:, :, None, None]
    # suffix union occ_after[k] = OR_{j>k} bins[j]: a flipped cumulative max
    incl = bins.flip(1).to(torch.uint8).cummax(dim=1).values.flip(1).bool()
    occ_after = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], dim=1)
    return rgbs, alphas, bins, occ_after


def _blend(image, rgbs, alphas, bins, patch_valid, mode: str):
    """Composite the P layers in paint order (P is small)."""
    for k in range(rgbs.shape[1]):
        if mode == "alpha":
            weight = torch.where(patch_valid[:, k, None, None], alphas[:, k],
                                 torch.zeros((), device=image.device))
        elif mode == "gaussian":
            weight = _box_blur_5x5(bins[:, k].float())
        else:  # basic
            weight = bins[:, k].float()
        image = image * (1.0 - weight[..., None]) + rgbs[:, k] * weight[..., None]
    return image


def _batched(fn, args, batched: bool):
    """Run ``fn`` on batched tensors; a single sample gains and loses a
    leading dimension of 1."""
    if batched:
        return fn(*args)
    out = fn(*(None if a is None else a[None] for a in args))
    return {k: v[0] for k, v in out.items()}


def paste_instances(
    image: torch.Tensor,  # (H, W, 3) float RGB
    masks: torch.Tensor,  # (N, H, W) bool dst instance masks
    boxes: torch.Tensor,  # (N, 4)
    classes: torch.Tensor,  # (N,) int
    valid: torch.Tensor,  # (N,) bool
    source: torch.Tensor,  # (N,) int 0 = real
    patches: torch.Tensor,  # (P, ph, pw, 4) RGBA, rgb 0..255, alpha 0..1
    patch_boxes: torch.Tensor,  # (P, 4) placement in image coords
    patch_classes: torch.Tensor,  # (P,) int
    patch_valid: torch.Tensor,  # (P,) bool
    patch_flip: Optional[torch.Tensor] = None,  # (P,) bool
    mode: str = "basic",
    bbox_occluded_thr: float = 10.0,
    mask_occluded_thr: float = 300.0,
    patch_angle: Optional[torch.Tensor] = None,  # (P,) radians
) -> Dict[str, torch.Tensor]:
    """Sequentially paste P instances onto one sample (or onto each sample of
    a batch). Static output capacity N+P; occluded dst instances are
    invalidated, not removed."""

    def fn(image, masks, boxes, classes, valid, source, patches, patch_boxes,
           patch_classes, patch_valid, patch_flip, patch_angle):
        n = masks.shape[1]
        rgbs, alphas, bins, occ_after = _layers(image, patches, patch_boxes, patch_valid,
                                                patch_flip, patch_angle)
        patch_masks = bins & ~occ_after
        dst_occ = bins.any(dim=1)
        all_masks = torch.cat([masks & ~dst_occ[:, None], patch_masks], dim=1)
        image_out = _blend(image, rgbs, alphas, bins, patch_valid, mode)

        new_boxes = boxes_from_masks(all_masks)
        areas = all_masks[:, :n].sum(dim=(2, 3))
        bbox_ok = ((new_boxes[:, :n] - boxes).abs() <= bbox_occluded_thr).all(dim=-1)
        dst_valid = valid & (bbox_ok | (areas > mask_occluded_thr))
        return {
            "image": image_out,
            "masks": all_masks,
            "boxes": new_boxes,
            "classes": torch.cat([classes, patch_classes], dim=1),
            "valid": torch.cat([dst_valid, patch_valid], dim=1),
            "instance_source": torch.cat([source, torch.ones_like(patch_classes, dtype=source.dtype)],
                                         dim=1),
        }

    args = (image, masks, boxes, classes, valid, source, patches, patch_boxes,
            patch_classes, patch_valid, patch_flip, patch_angle)
    return _batched(fn, args, image.dim() == 4)


def _crop_binary_batched(full: torch.Tensor, boxes: torch.Tensor, side: int) -> torch.Tensor:
    """full (L, H, W) float, boxes (L, K, 4) → (L, K, S, S): each box's S×S
    bilinear sampling grid over its sample's field, zero outside the frame."""
    h, w = full.shape[-2:]
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))
    steps = _arange(side, full) + 0.5
    ys = y1 + steps * (y2 - y1) / side - 0.5  # (L, K, S)
    xs = x1 + steps * (x2 - x1) / side - 0.5
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = (ys - y0)[..., :, None], (xs - x0)[..., None, :]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    lanes = torch.arange(full.shape[0], device=full.device)[:, None, None, None]
    zero = torch.zeros((), device=full.device)

    def at(yi, xi):
        v = full[lanes, yi.clamp(0, h - 1)[..., :, None], xi.clamp(0, w - 1)[..., None, :]]
        ok = ((yi >= 0) & (yi < h))[..., :, None] & ((xi >= 0) & (xi < w))[..., None, :]
        return torch.where(ok, v, zero)

    top = at(y0i, x0i) * (1 - lx) + at(y0i, x0i + 1) * lx
    bot = at(y0i + 1, x0i) * (1 - lx) + at(y0i + 1, x0i + 1) * lx
    return top * (1 - ly) + bot * ly


def _crop_binary(full: torch.Tensor, box: torch.Tensor, side: int) -> torch.Tensor:
    """Bilinear-sample a full-frame (H, W) float field on an S×S grid inside
    ``box`` (zero outside the frame)."""
    return _crop_binary_batched(full[None], box[None, None], side)[0, 0]


def _boxframe_subbox(mask: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Tight bbox (image coords) of (..., S, S) box-frame masks > 0.5 inside
    their boxes (..., 4); zero if empty."""
    s = mask.shape[-1]
    on = mask > 0.5
    xs = (_arange(s, mask) + 0.5) / s
    big = torch.tensor(1e9, device=mask.device)
    col_any = on.any(dim=-2)
    row_any = on.any(dim=-1)
    u1 = torch.where(col_any, xs, big).amin(-1)
    u2 = torch.where(col_any, xs, -big).amax(-1)
    v1 = torch.where(row_any, xs, big).amin(-1)
    v2 = torch.where(row_any, xs, -big).amax(-1)
    half = 0.5 / s
    x1, y1, x2, y2 = box.unbind(-1)
    bw, bh = x2 - x1, y2 - y1
    out = torch.stack([x1 + (u1 - half) * bw, y1 + (v1 - half) * bh,
                       x1 + (u2 + half) * bw, y1 + (v2 + half) * bh], dim=-1)
    return torch.where(col_any.any(dim=-1)[..., None], out,
                       torch.zeros((), device=mask.device))


def normalize_cp_method(method) -> str:
    """INPUT.CP_METHOD is a list in the BSGAL YAMLs (``['basic']``). The
    compositor takes one blend mode per call, so only single-method lists are
    supported."""
    if isinstance(method, (list, tuple)):
        if len(method) != 1:
            raise NotImplementedError(
                f"CP_METHOD={method}: per-paste random blend sampling is not "
                "supported on the static compositor; pick one method"
            )
        return method[0]
    return method


def paste_instances_boxframe(
    image: torch.Tensor,  # (H, W, 3)
    gt_masks: torch.Tensor,  # (N, S, S) float box-frame crops
    boxes: torch.Tensor,  # (N, 4)
    classes: torch.Tensor,
    valid: torch.Tensor,
    source: torch.Tensor,
    patches: torch.Tensor,  # (P, ps, ps, 4)
    patch_boxes: torch.Tensor,  # (P, 4)
    patch_classes: torch.Tensor,
    patch_valid: torch.Tensor,
    patch_flip: Optional[torch.Tensor] = None,
    mode: str = "basic",
    bbox_occluded_thr: float = 10.0,
    mask_occluded_thr: float = 300.0,
    patch_angle: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Copy-paste with box-frame instance masks, the memory-light form the
    trainer uses (masks are O((N+P)·S²), never (N, H, W)). Same sequential
    occlusion semantics as ``paste_instances``; dst masks and boxes are
    updated by cropping the paste union into each gt box frame; areas are
    estimated as mean(mask)·box_area. One sample, or a batch with a leading
    dimension on every argument."""

    def fn(image, gt_masks, boxes, classes, valid, source, patches, patch_boxes,
           patch_classes, patch_valid, patch_flip, patch_angle):
        b, h, w, _ = image.shape
        n, s = gt_masks.shape[1], gt_masks.shape[2]
        p = patches.shape[1]
        rgbs, alphas, bins, occ_after = _layers(image, patches, patch_boxes, patch_valid,
                                                patch_flip, patch_angle)
        union = bins.any(dim=1).float()

        # dst masks: subtract the union cropped into each box frame
        occ_crops = _crop_binary_batched(union, boxes, s)  # (B, N, S, S)
        new_gt_masks = torch.where(occ_crops > 0.5, torch.zeros((), device=image.device),
                                   gt_masks)
        # the patches' own masks in their own box frames
        per_patch = lambda t: _crop_binary_batched(
            t.float().reshape(b * p, h, w), patch_boxes.reshape(b * p, 1, 4), s
        ).reshape(b, p, s, s)
        own = per_patch(bins) * (1.0 - (per_patch(occ_after) > 0.5).float())

        all_masks = torch.cat([new_gt_masks, own], dim=1)
        new_boxes = _boxframe_subbox(all_masks, torch.cat([boxes, patch_boxes], dim=1))
        # untouched dst instances keep their exact original box (no S×S
        # raster-quantization drift against the occlusion threshold)
        touched = (occ_crops > 0.5).any(dim=(2, 3))
        new_boxes = torch.cat([torch.where(touched[..., None], new_boxes[:, :n], boxes),
                               new_boxes[:, n:]], dim=1)

        box_areas = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (
            boxes[..., 3] - boxes[..., 1]).clamp_min(0)
        areas = (new_gt_masks > 0.5).float().mean(dim=(2, 3)) * box_areas
        bbox_ok = ((new_boxes[:, :n] - boxes).abs() <= bbox_occluded_thr).all(dim=-1)
        dst_valid = valid & (bbox_ok | (areas > mask_occluded_thr))
        patch_ok = patch_valid & (own > 0.5).any(dim=(2, 3))
        return {
            "image": _blend(image, rgbs, alphas, bins, patch_valid, mode),
            "masks": all_masks,
            "boxes": new_boxes,
            "classes": torch.cat([classes, patch_classes], dim=1),
            "valid": torch.cat([dst_valid, patch_ok], dim=1),
            "instance_source": torch.cat([source, torch.ones_like(patch_classes, dtype=source.dtype)],
                                         dim=1),
        }

    args = (image, gt_masks, boxes, classes, valid, source, patches, patch_boxes,
            patch_classes, patch_valid, patch_flip, patch_angle)
    return _batched(fn, args, image.dim() == 4)


def paste_instances_batch(mode: str = "basic", **thresholds):
    """The compositor over a batch: returns ``fn(batch_sample)`` on a dict of
    batched tensors (``image``, ``masks``, ``boxes``, ``classes``, ``valid``,
    ``instance_source``, ``patches``, ``patch_boxes``, ``patch_classes``,
    ``patch_valid`` and optionally ``patch_flip``)."""

    def fn(batch_sample):
        return paste_instances(
            batch_sample["image"],
            batch_sample["masks"],
            batch_sample["boxes"],
            batch_sample["classes"],
            batch_sample["valid"],
            batch_sample["instance_source"],
            batch_sample["patches"],
            batch_sample["patch_boxes"],
            batch_sample["patch_classes"],
            batch_sample["patch_valid"],
            batch_sample.get("patch_flip"),
            mode=mode,
            **thresholds,
        )

    return fn
