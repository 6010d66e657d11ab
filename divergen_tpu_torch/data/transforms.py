"""Host-side geometric transforms (numpy): scale-jitter resize-crop + flip.

Counterpart of ``divergen_tpu/data/transforms.py``, a copy but for the
resize: the JAX package calls ``cv2.resize``, the port ``resize_image``
(``F.interpolate``; bilinear within one level of OpenCV's 11-bit fixed point
on uint8, nearest equal to OpenCV's). The JAX module's sources: ``DiverGen/divergen/data/transforms/custom_augmentation_impl.py:25-72``
(``EfficientDetResizeCrop``) and ``custom_transform.py:28-114``
(``EfficientDetResizeCropTransform`` incl. ``inverse_apply_box`` used by the
evaluator), plus detectron2's ``RandomFlip``. These run in the host loader;
only decode/resize stays on CPU — compositing and normalization are
on-device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_image(img: np.ndarray, h: int, w: int, nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST if nearest else
    INTER_LINEAR)`` for an (H, W) or (H, W, C) array, on the CPU.

    Bilinear is ``F.interpolate`` with ``align_corners=False`` and no
    antialias, in float32, rounded half up: OpenCV's uint8 path rounds its
    coefficients to 11 bits, so a pixel may differ by one level (an exact 2x
    shrink, which OpenCV takes as INTER_AREA, is exact). Nearest takes source
    index floor(x · (1 / (w / W))) in float64, clipped, as OpenCV does, so it
    is exact."""
    src_h, src_w = img.shape[:2]
    if (src_h, src_w) == (h, w):
        return img.copy()
    if nearest:
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / src_h))).astype(np.int64), src_h - 1)
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / src_w))).astype(np.int64), src_w - 1)
        return np.ascontiguousarray(img[ys][:, xs])
    x = torch.from_numpy(np.ascontiguousarray(img)).float()
    x = x[None, None] if img.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    y = y[0, 0] if img.ndim == 2 else y[0].permute(1, 2, 0)
    if img.dtype == np.uint8:
        y = torch.floor(y + 0.5).clamp_(0, 255)
    return y.numpy().astype(img.dtype)


class ResizeCropTransform:
    """Deterministic resize→offset-crop; records params for inversion."""

    def __init__(self, scaled_h: int, scaled_w: int, offset_y: int, offset_x: int,
                 img_scale: float, target_size: Tuple[int, int]):
        self.scaled_h = scaled_h
        self.scaled_w = scaled_w
        self.offset_y = offset_y
        self.offset_x = offset_x
        self.img_scale = img_scale
        self.target_size = target_size

    def apply_image(self, img: np.ndarray, nearest: bool = False) -> np.ndarray:
        ret = resize_image(img, self.scaled_h, self.scaled_w, nearest=nearest)
        lower = min(self.scaled_h, self.offset_y + self.target_size[0])
        right = min(self.scaled_w, self.offset_x + self.target_size[1])
        return ret[self.offset_y : lower, self.offset_x : right]

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.astype(np.float32).copy()
        coords[:, 0] = coords[:, 0] * self.img_scale - self.offset_x
        coords[:, 1] = coords[:, 1] * self.img_scale - self.offset_y
        return coords

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        b = boxes.astype(np.float32).copy()
        b[:, [0, 2]] = b[:, [0, 2]] * self.img_scale - self.offset_x
        b[:, [1, 3]] = b[:, [1, 3]] * self.img_scale - self.offset_y
        return b

    def inverse_apply_box(self, boxes: np.ndarray) -> np.ndarray:
        """(custom_transform.py:96-114) — eval-time back-projection."""
        b = boxes.astype(np.float32).copy()
        b[:, [0, 2]] = (b[:, [0, 2]] + self.offset_x) / self.img_scale
        b[:, [1, 3]] = (b[:, [1, 3]] + self.offset_y) / self.img_scale
        return b


class FlipTransform:
    def __init__(self, width: int, do: bool):
        self.width = width
        self.do = do

    def apply_image(self, img: np.ndarray, nearest: bool = False) -> np.ndarray:
        return img[:, ::-1] if self.do else img

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        if not self.do:
            return coords
        coords = coords.copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        if not self.do:
            return boxes
        b = boxes.copy()
        b[:, [0, 2]] = self.width - b[:, [2, 0]]
        return b

    def inverse_apply_box(self, boxes: np.ndarray) -> np.ndarray:
        return self.apply_box(boxes)


class EfficientDetResizeCrop:
    """Random scale-jitter resize + random crop to a square target.

    size>0 → square (size,size) output; size -1 → pure scale.
    """

    def __init__(self, size: int, scale: Tuple[float, float] = (0.1, 2.0)):
        self.size = size
        self.scale = scale

    def get_transform(self, img: np.ndarray, rng: np.random.Generator) -> ResizeCropTransform:
        scale_factor = rng.uniform(*self.scale)
        h, w = img.shape[:2]
        if self.size > 0:
            img_scale = min(scale_factor * self.size / h, scale_factor * self.size / w)
            target = (self.size, self.size)
        else:
            img_scale = scale_factor
            target = None
        scaled_h = max(1, int(h * img_scale))
        scaled_w = max(1, int(w * img_scale))
        if target is None:
            target = (scaled_h, scaled_w)
            off_y = off_x = 0
        else:
            off_y = int(max(0, scaled_h - target[0]) * rng.uniform(0, 1))
            off_x = int(max(0, scaled_w - target[1]) * rng.uniform(0, 1))
        return ResizeCropTransform(scaled_h, scaled_w, off_y, off_x, img_scale, target)


class ResizeShortestEdge:
    """Test-time resize: shorter edge to `short`, longer capped at `max_size`
    (detectron2 ResizeShortestEdge semantics, used by the test mapper)."""

    def __init__(self, short: int, max_size: int):
        self.short = short
        self.max_size = max_size

    def get_transform(self, img: np.ndarray, rng=None) -> ResizeCropTransform:
        h, w = img.shape[:2]
        scale = self.short / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        sh, sw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
        return ResizeCropTransform(sh, sw, 0, 0, scale, (sh, sw))


class RandomFlip:
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def get_transform(self, img: np.ndarray, rng: np.random.Generator) -> FlipTransform:
        return FlipTransform(img.shape[1], bool(rng.random() < self.prob))


class TransformList:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def apply_image(self, img, nearest: bool = False):
        for t in self.transforms:
            img = t.apply_image(img, nearest=nearest)
        return img

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_box(self, boxes):
        for t in self.transforms:
            boxes = t.apply_box(boxes)
        return boxes

    def inverse_apply_box(self, boxes):
        for t in reversed(self.transforms):
            boxes = t.inverse_apply_box(boxes)
        return boxes


def apply_augmentations(augs: Sequence, img: np.ndarray, rng: np.random.Generator):
    """detectron2 AugmentationList: sample each aug's transform on the
    progressively transformed image."""
    tfms = []
    for aug in augs:
        t = aug.get_transform(img, rng)
        img = t.apply_image(img)
        tfms.append(t)
    return img, TransformList(tfms)
