"""Photometric distortion, frequency-filtered per category (host numpy).

Counterpart of ``divergen_tpu/data/color_jitter.py``: the same
``np.random.Generator`` draws in the same order, with OpenCV's ``cvtColor``
RGB <-> HSV and float32 ``resize`` taken from ``native/imgproc.cpp``. The JAX
module's sources: ``DiverGen/divergen/data/transforms/custom_color_jitter.py:
24-163`` (PhotoMetricDistortion: brightness -> contrast (mode 0|1) -> HSV
saturation / hue -> channel swap, each with probability 0.5; applied only
where instances of the configured frequency buckets are, through the union of
their masks). Gt masks live in box frames, so the union is rasterized from
(box, mask) pairs onto the image.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .. import native


class PhotoMetricDistortion:
    def __init__(
        self,
        cid_to_freq: Dict[int, str],
        freq_color_filter: Sequence[str] = ("r", "c", "f"),
        brightness_delta: int = 32,
        contrast_range=(0.5, 1.5),
        saturation_range=(0.5, 1.5),
        hue_delta: int = 18,
    ):
        self.cid_to_freq = cid_to_freq
        self.freq_filter = set(freq_color_filter)
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def apply_img(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img = img.astype(np.float32)
        if rng.integers(2):
            img += rng.uniform(-self.brightness_delta, self.brightness_delta)
        mode = int(rng.integers(2))
        if mode == 1 and rng.integers(2):
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        hsv = native.rgb_to_hsv(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
        if rng.integers(2):
            hsv[..., 1] *= rng.uniform(self.saturation_lower, self.saturation_upper)
        if rng.integers(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.hue_delta, self.hue_delta)) % 180
        img = native.hsv_to_rgb(np.clip(hsv, 0, 255).astype(np.uint8)).astype(np.float32)
        if mode == 0 and rng.integers(2):
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        if rng.integers(2):
            img = img[..., rng.permutation(3)]
        return np.clip(img, 0, 255)

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        gt = sample["gt"]
        keep = [
            i
            for i in np.where(gt["valid"])[0]
            if self.cid_to_freq.get(int(gt["classes"][i]), "f") in self.freq_filter
        ]
        if not keep:
            return sample
        img = sample["image"]
        jittered = self.apply_img(img, rng)
        h, w = img.shape[:2]
        union = np.zeros((h, w), np.float32)
        for i in keep:
            x1, y1, x2, y2 = gt["boxes"][i]
            x1i, y1i = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
            x2i, y2i = min(int(np.ceil(x2)), w), min(int(np.ceil(y2)), h)
            if x2i <= x1i or y2i <= y1i:
                continue
            m = native.resize_linear(gt["masks"][i].astype(np.float32), y2i - y1i, x2i - x1i)
            union[y1i:y2i, x1i:x2i] = np.maximum(union[y1i:y2i, x1i:x2i], m)
        blend = (union >= 0.5)[..., None]
        sample["image"] = np.where(blend, jittered, img).astype(img.dtype)
        return sample
