"""Host-side RGBA instance pool: selection + decode only.

A copy of ``divergen_tpu/data/inst_pool.py`` without OpenCV: PNGs are read by
``utils/png.py`` (8-bit RGBA, RGB and gray; an entry it cannot read is
skipped, as the JAX package's ``except Exception: return None``), the largest
part of an alpha mask is OpenCV's ``findContours`` + ``contourArea`` +
``fillPoly`` rebuilt in ``native/`` (``external_contours``,
``contour_area``, ``fill_polygon``: the same pixels), and the patch resize is
``data/transforms.py:resize_image`` (``F.interpolate``, bilinear, on float32:
OpenCV's ``INTER_LINEAR`` up to rounding). Selections draw the same numbers
from the same ``np.random.Generator`` as the JAX package's.

The JAX module's sources: ``DiverGen/divergen/data/custom_build_copypaste_mapper.py:94-506``
(``InstPool``) and the BSGAL variant (``BSGAL/bsgal/data/…:118-660``), split
at the host/device boundary: this class only *chooses* instances, decodes
RGBA patches to a canonical square size, samples per-category size priors
and placements; the compositing (blend/occlusion/bboxes) runs on the device
in ``ops/copy_paste.py``. Static paste capacity per image keeps the device
program shape-stable (invalid slots are masked).

Parity map:
- pool JSON {cat_id: ["x.png" | "img|mask", ...]} (mapper :115-134)
- frequency filtering ``apply_freq`` + ``filter_val`` (:119-131)
- per-category size prior: area = clip(mean+randn*std, smin, smax), target
  area = area^2·H·W, aspect = native·U(1±shape_jitter) (:399-444)
- uniform ``random_scale`` mode (:386-398)
- alpha>128 → largest contour → bbox crop (:415-431, get_largest_connect_component :25)
- sampling strategies random / cas_random / cats_random (:240-250), the
  frequency buckets and the transition-matrix strategies of BSGAL
- num pastes ~ randint(0, max_samples) with a dedicated order-seed stream
  (:183-236)
- placement: instance center uniform over the train canvas
  (random_start_xy :45-56)
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..utils.png import read_gray, read_png, read_rgb
from .transforms import resize_image

FREQ_KEYS = ("r", "c", "f")


def largest_component(mask: np.ndarray) -> np.ndarray:
    """Largest external contour, filled (reference semantics incl. holes):
    the outer border of largest shoelace area (the first in
    ``findContours``' order on a tie; a one-pixel line has area 0) with its
    holes filled, as uint8 0 / 1; a mask without a contour unchanged."""
    contours = native.external_contours(mask)
    if not contours:
        return mask.astype(np.uint8)
    areas = [native.contour_area(c) for c in contours]
    out = np.zeros(mask.shape, np.uint8)
    native.fill_polygon(out, contours[int(np.argmax(areas))])
    return out


class InstPool:
    def __init__(
        self,
        json_file: str,
        image_root: str = "",
        train_size: Tuple[int, int] = (896, 896),
        max_samples: int = 20,
        patch_size: int = 128,
        use_largest_part: bool = True,
        filter_val: bool = False,
        filter_val_path: Optional[str] = None,
        apply_freq: Sequence[str] = ("r", "c", "f"),
        cat_freq_path: Optional[str] = None,
        mean_std2_path: Optional[str] = None,
        random_scale: bool = False,
        random_scale_min: float = 0.1,
        random_scale_max: float = 2.0,
        random_scale_min_size: int = 5,
        shape_jitter: float = 0.2,
        scale_min: float | int = 10,
        scale_max: float | int = 0.5,
        instance_filter_min: float = 0.01,
        instance_filter_max: float = 1.0,
        mask_threshold: int = 128,
        order_seed: Optional[int] = None,
    ):
        with open(json_file) as f:
            per_cat = {int(k): v for k, v in json.load(f).items()}

        if cat_freq_path:
            with open(cat_freq_path) as f:
                infos = json.load(f)
            select = {info["id"] - 1 for info in infos if info["frequency"] in apply_freq}
            per_cat = {c: v for c, v in per_cat.items() if c in select}
        if filter_val and filter_val_path:
            with open(filter_val_path) as f:
                drop = {i - 1 for i in json.load(f)}
            per_cat = {c: v for c, v in per_cat.items() if c not in drop}

        self.image_root = image_root
        self.dataset: List[str] = []
        self.data_to_cat: Dict[int, int] = {}
        self.per_cat_pool: Dict[int, List[int]] = {}
        for c, entries in per_cat.items():
            idxs = list(range(len(self.dataset), len(self.dataset) + len(entries)))
            self.per_cat_pool[c] = idxs
            for i, e in zip(idxs, entries):
                self.data_to_cat[i] = c
            self.dataset += entries
        self.cats = list(self.per_cat_pool.keys())

        self.size_priors: Dict[str, List[float]] = {}
        if mean_std2_path:
            with open(mean_std2_path) as f:
                self.size_priors = json.load(f)

        self.train_size = tuple(train_size)
        self.max_samples = max_samples
        self.patch_size = patch_size
        self.use_largest_part = use_largest_part
        self.random_scale = random_scale
        self.random_scale_min = random_scale_min
        self.random_scale_max = random_scale_max
        self.random_scale_min_size = random_scale_min_size
        self.shape_jitter = shape_jitter
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.instance_filter_min = instance_filter_min
        self.instance_filter_max = instance_filter_max
        self.mask_threshold = mask_threshold
        # dedicated, worker-stable stream for the paste-count/order decisions
        self.order_rng = np.random.default_rng(order_seed) if order_seed is not None else None

    # -- selection ------------------------------------------------------
    def set_freq_groups(self, groups: Dict[str, set]) -> None:
        """rare/common/frequent 0-based id sets (datasets.lvis.frequency_groups)
        — enables the BSGAL bucket strategies (mapper :210-233)."""
        self.freq_groups = groups

    def set_transition_matrix(self, matrix: np.ndarray) -> None:
        """(C, C) category transition matrix for prob strategies
        (INPUT.TRANSITION_MATRIX_PATH, BSGAL mapper :350-394)."""
        self.transition_matrix = np.asarray(matrix, np.float64)

    def _balanced(self, rng, num: int, cats: Sequence[int]) -> List[int]:
        cats = [c for c in cats if c in self.per_cat_pool and self.per_cat_pool[c]]
        if not cats:
            return []
        picks = rng.integers(0, len(cats), num)
        return [
            self.per_cat_pool[cats[p]][rng.integers(0, len(self.per_cat_pool[cats[p]]))]
            for p in picks
        ]

    def sample_ids(self, rng: np.random.Generator, num: int, sample_type: str = "random",
                   cids: Optional[Sequence[int]] = None,
                   label_set: Optional[Sequence[int]] = None) -> List[int]:
        if num <= 0 or not self.dataset:
            return []
        if sample_type == "random":
            return list(rng.integers(0, len(self.dataset), num))
        if sample_type in ("cas_random", "cats_random"):
            cats = list(cids) if (sample_type == "cats_random" and cids) else self.cats
            return self._balanced(rng, num, cats)
        groups = getattr(self, "freq_groups", None)
        if sample_type in ("rare_random", "com_random", "fre_random",
                           "rare_and_common_random", "rcf_random"):
            assert groups is not None, "call set_freq_groups() first"
            sel = {
                "rare_random": groups["r"],
                "com_random": groups["c"],
                "fre_random": groups["f"],
                "rare_and_common_random": groups["r"] | groups["c"],
                "rcf_random": groups["r"] | groups["c"] | groups["f"],
            }[sample_type]
            return self._balanced(rng, num, sorted(sel))
        if sample_type in ("prob_random", "binary_prob_random"):
            tm = getattr(self, "transition_matrix", None)
            assert tm is not None, "call set_transition_matrix() first"
            labels = list(label_set or [])
            dist = tm[labels].sum(axis=0) if labels else np.zeros(tm.shape[1])
            if sample_type == "binary_prob_random":
                # balance rare vs non-rare among co-occurring categories
                # (BSGAL mapper :368-394)
                dist = (dist > 0).astype(np.float64)
                if groups:
                    nz = set(np.nonzero(dist)[0].tolist())
                    rare_nz = nz & groups["r"]
                    not_rare = sorted(nz - groups["r"])
                    mask_n = max(len(not_rare) - len(rare_nz), 0)
                    if mask_n and not_rare:
                        off = rng.choice(not_rare, min(mask_n, len(not_rare)), replace=False)
                        dist[off] = 0
            if dist.sum() <= 0:
                dist = np.ones_like(dist)
            # zero out categories absent from the pool
            avail = np.zeros_like(dist)
            for c in self.per_cat_pool:
                if c < len(avail) and self.per_cat_pool[c]:
                    avail[c] = 1
            dist = dist * avail
            if dist.sum() <= 0:
                dist = avail
            dist = dist / dist.sum()
            out = []
            for _ in range(num):
                c = int(rng.choice(len(dist), p=dist))
                pool = self.per_cat_pool[c]
                out.append(pool[int(rng.integers(0, len(pool)))])
            return out
        if sample_type.startswith("one_class_random"):
            cats = list(cids) if cids else self.cats
            cat = cats[int(rng.integers(0, len(cats)))]
            return self._balanced(rng, num, [cat])
        raise NotImplementedError(sample_type)

    # -- decode ---------------------------------------------------------
    def load_rgba(self, idx: int) -> Optional[np.ndarray]:
        """Decode one pool entry to an RGBA float array (rgb 0..255,
        alpha 0..255), alpha cleaned + cropped to its bbox; None for an entry
        that cannot be read (any error, as the JAX package's), is not RGBA,
        or keeps too little or too much of its area."""
        entry = self.dataset[idx]
        try:
            if "|" in entry:
                img_path, mask_path = entry.split("|")
                img = read_rgb(os.path.join(self.image_root, img_path))
                alpha = read_gray(os.path.join(self.image_root, mask_path))
                rgba = np.concatenate([img, alpha[..., None]], -1).astype(np.float32)
            else:
                raw = read_png(os.path.join(self.image_root, entry))
                if raw.ndim != 3 or raw.shape[-1] != 4:
                    return None
                rgba = raw.astype(np.float32)
        except Exception:
            return None

        seg = (rgba[..., 3] > self.mask_threshold).astype(np.uint8)
        if self.use_largest_part:
            seg = largest_component(seg)
        ys, xs = np.where(seg)
        if len(ys) == 0:
            return None
        frac = len(ys) / seg.size
        if frac <= self.instance_filter_min or frac >= self.instance_filter_max:
            return None
        rgba[..., 3] *= seg
        return rgba[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]

    # -- geometry -------------------------------------------------------
    def sample_target_hw(
        self, rng: np.random.Generator, cat_id: int, native_hw: Tuple[int, int]
    ) -> Optional[Tuple[int, int]]:
        """Target (H, W) in train-canvas pixels from the per-category area
        prior (mapper :386-444)."""
        img_h, img_w = self.train_size
        key = str(cat_id + 1)  # mean_std2 json is 1-indexed
        if self.random_scale or key not in self.size_priors:
            s = rng.uniform(self.random_scale_min, self.random_scale_max)
            th, tw = int(native_hw[0] * s), int(native_hw[1] * s)
            if th < self.random_scale_min_size or tw < self.random_scale_min_size:
                return None
            if th >= img_h or tw >= img_w:
                return None
            return th, tw
        mean, std = self.size_priors[key][:2]
        smin = self.scale_min / img_h if isinstance(self.scale_min, int) else self.scale_min
        smax = self.scale_max / img_h if isinstance(self.scale_max, int) else self.scale_max
        area = float(np.clip(mean + rng.standard_normal() * std, smin, smax))
        scale = area**2 * img_h * img_w
        ratio = native_hw[1] / native_hw[0] * rng.uniform(1 - self.shape_jitter, 1 + self.shape_jitter)
        tw = int(np.sqrt(ratio * scale))
        th = int(tw / ratio) if ratio > 0 else 0
        if tw < 5 or tw >= img_w or th < 5 or th >= img_h:
            return None
        return th, tw

    def sample_placement(
        self, rng: np.random.Generator, target_hw: Tuple[int, int]
    ) -> np.ndarray:
        """x1,y1,x2,y2 with the instance center uniform over the canvas
        (random_start_xy semantics — may extend past borders)."""
        img_h, img_w = self.train_size
        th, tw = target_hw
        cx = rng.integers(0, img_w)
        cy = rng.integers(0, img_h)
        x1 = cx - tw / 2.0
        y1 = cy - th / 2.0
        return np.array([x1, y1, x1 + tw, y1 + th], np.float32)

    # -- batch assembly --------------------------------------------------
    def make_paste_sample(
        self,
        rng: np.random.Generator,
        max_pastes: int,
        sample_type: str = "random",
        cids: Optional[Sequence[int]] = None,
        flip_prob: float = 0.5,
    ) -> Dict[str, np.ndarray]:
        """Fixed-capacity paste inputs for ONE image (device-ready numpy)."""
        ps = self.patch_size
        out = {
            "patches": np.zeros((max_pastes, ps, ps, 4), np.float32),
            "patch_boxes": np.zeros((max_pastes, 4), np.float32),
            "patch_classes": np.zeros((max_pastes,), np.int32),
            "patch_valid": np.zeros((max_pastes,), bool),
            "patch_flip": np.zeros((max_pastes,), bool),
            # host-side provenance for the BSGAL decision logs
            # (paste_filename_list, bsgal mapper :556,610-619); stays on host
            "patch_filenames": np.full((max_pastes,), "", dtype="<U256"),
        }
        count_rng = self.order_rng if self.order_rng is not None else rng
        num = int(count_rng.integers(0, self.max_samples)) if self.max_samples > 0 else 0
        num = min(num, max_pastes)
        ids = self.sample_ids(rng, num, sample_type, cids)
        slot = 0
        for idx in ids:
            rgba = self.load_rgba(int(idx))
            if rgba is None:
                continue
            cat = self.data_to_cat[int(idx)]
            target = self.sample_target_hw(rng, cat, rgba.shape[:2])
            if target is None:
                continue
            patch = resize_image(rgba, ps, ps)
            out["patches"][slot] = patch
            out["patches"][slot, ..., 3] /= 255.0
            out["patch_boxes"][slot] = self.sample_placement(rng, target)
            out["patch_classes"][slot] = cat
            out["patch_valid"][slot] = True
            out["patch_flip"][slot] = rng.random() < flip_prob
            out["patch_filenames"][slot] = str(self.dataset[int(idx)])[:256]
            slot += 1
            if slot >= max_pastes:
                break
        return out
