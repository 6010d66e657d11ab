"""Inpaint-rotate augmentation for rare classes (host prep + device paste).

Counterpart of ``divergen_tpu/data/inp_rotate.py``: the same draws, with
OpenCV's float32 ``resize``, ``dilate`` and ``inpaint`` (Telea) taken from
``native/``. The host inpaints the instances out of the background and cuts
them to RGBA patches; the rotation and compositing happen in the device
compositor (``ops/copy_paste.py``, the patch ``angle``). The JAX module's
sources: ``DiverGen/divergen/data/transforms/custom_copypaste.py:111-240``
(``_inp_rotate``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import native


def inp_rotate_sample(
    sample: Dict,
    rng: np.random.Generator,
    patch_size: int = 128,
    max_pastes: int = 8,
    angle_range: float = 30.0,
    freq_filter: Optional[set] = None,
    cid_to_freq: Optional[Dict[int, str]] = None,
) -> Dict:
    """Take a mapper sample (box-frame gt masks), inpaint the instances out
    of the image, and emit them as rotated paste patches. Returns the sample
    with image replaced and patch slots filled; original instances are
    invalidated (the pasted copies carry the supervision)."""
    gt = sample["gt"]
    img = sample["image"]
    h, w = img.shape[:2]
    valid_idx = [
        i
        for i in np.where(gt["valid"])[0]
        if freq_filter is None
        or (cid_to_freq or {}).get(int(gt["classes"][i]), "f") in freq_filter
    ]
    if not valid_idx:
        return sample

    inpaint_mask = np.zeros((h, w), np.uint8)
    patches = np.zeros((max_pastes, patch_size, patch_size, 4), np.float32)
    pboxes = np.zeros((max_pastes, 4), np.float32)
    pcls = np.zeros((max_pastes,), np.int32)
    pval = np.zeros((max_pastes,), bool)
    pang = np.zeros((max_pastes,), np.float32)

    slot = 0
    used = []
    for i in valid_idx:
        if slot >= max_pastes:
            break
        x1, y1, x2, y2 = [int(round(v)) for v in gt["boxes"][i]]
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, w), min(y2, h)
        if x2 - x1 < 4 or y2 - y1 < 4:
            continue
        m = native.resize_linear(gt["masks"][i].astype(np.float32), y2 - y1, x2 - x1) >= 0.5
        inpaint_mask[y1:y2, x1:x2] |= m.astype(np.uint8)
        rgba = np.dstack([img[y1:y2, x1:x2], m.astype(np.float32)])
        patches[slot] = native.resize_linear(rgba.astype(np.float32), patch_size, patch_size)
        # same box, random rotation (reference rotates in place ±30°)
        pboxes[slot] = [x1, y1, x2, y2]
        pcls[slot] = gt["classes"][i]
        pval[slot] = True
        pang[slot] = np.deg2rad(rng.uniform(-angle_range, angle_range))
        used.append(i)
        slot += 1

    if not used:
        return sample
    # inpaint the cut instances out of the background (cv2.INPAINT_TELEA)
    bg = native.inpaint_telea(
        np.clip(img, 0, 255).astype(np.uint8), native.dilate(inpaint_mask, (5, 5)), 5,
    ).astype(np.float32)

    out = dict(sample)
    out["image"] = bg
    gt = {k: v.copy() for k, v in gt.items()}
    for i in used:
        gt["valid"][i] = False  # the rotated pasted copy replaces it
    out["gt"] = gt
    out["patches"] = patches
    out["patch_boxes"] = pboxes
    out["patch_classes"] = pcls
    out["patch_valid"] = pval
    out["patch_flip"] = np.zeros((max_pastes,), bool)
    out["patch_angle"] = pang
    return out
