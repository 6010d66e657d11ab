"""CopyPasteMapper: per-sample augmentation orchestration (host side).

A copy of ``divergen_tpu/data/copy_paste_mapper.py`` without OpenCV (the
self-copy crops are resized by ``data/transforms.py:resize_image`` in
float32, ``INTER_LINEAR`` up to rounding): ``syn_copy`` / ``self_copy`` /
``both`` / ``p:<f>``, ``set_dataset`` with RC_ONLY / F_ONLY and RFS v0 / v1,
every self-copy mode, the blank-ratio rescale and ``SEPARATE_SYN``. Not yet
ported, and raising when the config asks for them: ``USE_COLOR_JITTER``,
``USE_INSTABOOST`` and ``USE_INP_ROTATE`` (ROADMAP.md §1, item 6d).

The JAX module's sources: ``DiverGen/divergen/data/custom_build_copypaste_mapper.py:669-958``
(CopyPasteMapper: base mapper → copy-method select both/self_copy/syn_copy/
"p:<f>" :884-890 → InstPool syn-copy / self-copy source picks → paste),
split at the host/device boundary: this class only assembles decode-level
inputs (base sample + RGBA patch stack); blending/occlusion runs on the
device (ops/copy_paste.py). Self-copy (the X-Paste SCP transform,
``transforms/custom_copypaste.py:29-514``) is realized through the same
device compositor: source instances are cut to RGBA patches using their
box-frame masks and pasted like pool instances.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .dataset_mapper import DatasetMapper
from .inst_pool import InstPool
from .transforms import resize_image


class CopyPasteMapper:
    def __init__(self, mapper: DatasetMapper, cfg, inst_pool: Optional[InstPool] = None):
        self.mapper = mapper
        self.cfg = cfg
        self.use_pool = bool(cfg.INPUT.INST_POOL)
        self.copy_method = cfg.INPUT.COPY_METHOD  # both|self_copy|syn_copy|p:<f>
        self.self_copy_prob = 0.5
        if self.copy_method.startswith("p:"):
            self.self_copy_prob = float(self.copy_method[2:])
        self.max_pastes = cfg.DATALOADER.MAX_PASTES
        self.sample_type = cfg.INPUT.INST_POOL_SAMPLE_STRATEGY
        self.rm_bg_prob = cfg.INPUT.RM_BG_PROB
        self.self_copy_mode = cfg.INPUT.SELF_COPY_MODE  # random|in_domain|cas|the_cls
        self.scp_select_cls = list(cfg.INPUT.get("SELF_COPY_CLS", []))
        self.per_cat_map: Dict[int, List[int]] = {}
        self.repeat_probs = None
        self.pool = inst_pool
        if self.use_pool and inst_pool is None:
            self.pool = InstPool(
                cfg.INPUT.INST_POOL_PATH,
                image_root=cfg.INPUT.INST_POOL_ROOT,
                train_size=(cfg.INPUT.TRAIN_SIZE, cfg.INPUT.TRAIN_SIZE),
                max_samples=cfg.INPUT.PASTE_MAX_INST,
                patch_size=cfg.DATALOADER.PATCH_SIZE,
                apply_freq=tuple(cfg.INPUT.INST_POOL_FREQ),
                cat_freq_path=cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH or None,
                mean_std2_path=cfg.INPUT.AREA_PRIOR_PATH or None,
                random_scale=cfg.INPUT.RANDOM_SCALE,
                random_scale_min=cfg.INPUT.RANDOM_SCALE_MIN,
                random_scale_max=cfg.INPUT.RANDOM_SCALE_MAX,
                random_scale_min_size=cfg.INPUT.RANDOM_SCALE_MIN_SIZE,
            )
        self.dataset: Optional[List[dict]] = None
        for key in ("USE_COLOR_JITTER", "USE_INSTABOOST", "USE_INP_ROTATE"):
            if cfg.INPUT.get(key, False):
                raise NotImplementedError(
                    f"INPUT.{key} is not yet ported (ROADMAP.md §1, item 6d)")

    def set_dataset(self, dataset: Sequence[dict]) -> None:
        """Raw records for self-copy source sampling (mapper.set_dataset,
        train_net.py:239 → custom_build_copypaste_mapper.py:817-854):
        rc_only/f_only frequency filtering, the per-category source index
        for class-conditioned modes, and RFS v0 (probability weights) /
        v1 (repeat-expanded dataset)."""
        i = self.cfg.INPUT
        dataset = list(dataset)
        self._cid_to_freq = {}
        if self.cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH:
            import json, os

            p = self.cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH
            if os.path.exists(p):
                with open(p) as f:
                    self._cid_to_freq = {c["id"] - 1: c["frequency"] for c in json.load(f)}
        if (i.RC_ONLY or i.F_ONLY) and self._cid_to_freq:
            keep = {"f"} if i.F_ONLY else {"r", "c"}
            filtered = []
            for rec in dataset:
                rec = dict(rec)
                anns = [
                    a for a in rec.get("annotations", [])
                    if self._cid_to_freq.get(a["category_id"], "f") in keep
                ]
                if anns:
                    rec["annotations"] = anns
                    filtered.append(rec)
            dataset = filtered
        self.per_cat_map: Dict[int, List[int]] = {}
        if self.self_copy_mode in ("in_domain", "cas", "the_cls"):
            for idx, rec in enumerate(dataset):
                for cid in {a["category_id"] for a in rec.get("annotations", [])}:
                    self.per_cat_map.setdefault(cid, []).append(idx)
        self.repeat_probs = None
        if i.USE_RFS:
            from .samplers import repeat_factors_from_category_frequency

            rf = repeat_factors_from_category_frequency(
                dataset, self.cfg.DATALOADER.REPEAT_THRESHOLD
            )
            if i.RFS_VERSION == 0:
                self.repeat_probs = rf / rf.sum()
            else:
                # v1: stochastic-round the repeat factors and physically
                # expand the source list (mapper :843-853)
                r = np.random.default_rng(0)
                reps = np.trunc(rf) + (r.random(len(rf)) < (rf - np.trunc(rf)))
                dataset = [
                    rec for rec, n in zip(dataset, reps.astype(int)) for _ in range(n)
                ]
        self.dataset = dataset

    def _pick_sources(self, rng: np.random.Generator, dst_gt, num_src: int = 1):
        """Source record indices + allowed-class filter per mode
        (_filter_in_specific_cls, mapper :783-815)."""
        mode = self.self_copy_mode
        if mode in ("in_domain", "cas", "the_cls") and self.per_cat_map:
            if mode == "the_cls" and self.scp_select_cls:
                pool_cls = [c for c in self.scp_select_cls if c in self.per_cat_map]
            elif mode == "cas":
                pool_cls = list(self.per_cat_map.keys())
            else:  # in_domain: classes present in the destination image
                pool_cls = [
                    int(c)
                    for c in np.unique(np.asarray(dst_gt["classes"])[np.asarray(dst_gt["valid"])])
                    if int(c) in self.per_cat_map
                ]
            if not pool_cls:
                return [], None
            cls_list = [int(rng.choice(pool_cls)) for _ in range(num_src)]
            idxs = [int(rng.choice(self.per_cat_map[c])) for c in cls_list]
            return idxs, set(cls_list)
        n = len(self.dataset)
        if self.repeat_probs is not None:
            return [int(rng.choice(n, p=self.repeat_probs)) for _ in range(num_src)], None
        return [int(rng.integers(0, n)) for _ in range(num_src)], None

    # -- self-copy: cut instances out of another real image --------------
    def _self_copy_patches(
        self,
        rng: np.random.Generator,
        max_pastes: int,
        ps: int,
        dst_gt: Optional[dict] = None,
        dst_size: Optional[tuple] = None,
    ) -> Dict[str, np.ndarray]:
        out = _empty_patches(max_pastes, ps)
        if not self.dataset:
            return out
        idxs, cls_filter = self._pick_sources(rng, dst_gt or {"classes": [], "valid": []})
        if not idxs:
            return out
        try:
            src = self.mapper(self.dataset[idxs[0]], rng)
        except FileNotFoundError:
            return out
        valid_idx = np.where(src["gt"]["valid"])[0]
        if cls_filter is not None:  # filter_cls_inst: keep the chosen classes
            valid_idx = np.array(
                [i for i in valid_idx if int(src["gt"]["classes"][i]) in cls_filter],
                dtype=np.int64,
            )
        if len(valid_idx) == 0:
            return out
        n_sel = int(rng.integers(1, min(len(valid_idx), max_pastes) + 1))
        chosen = rng.choice(valid_idx, n_sel, replace=False)

        # blank-ratio rescale (custom_copypaste.py:356-375): if the source
        # content extends far beyond the destination content area, scale the
        # source boxes down to ~destination size before pasting.
        scale = 1.0
        blank_ratio = float(self.cfg.INPUT.BLANK_RATIO)
        if blank_ratio > 0:
            boxes_sel = src["gt"]["boxes"][chosen]
            h2 = float(np.ceil(boxes_sel[:, 3].max()))
            w2 = float(np.ceil(boxes_sel[:, 2].max()))
            if dst_size is not None:
                h1, w1 = float(dst_size[0]), float(dst_size[1])
            else:
                h1, w1 = float(src["image"].shape[0]), float(src["image"].shape[1])
            h, w = max(h1, h2), max(w1, w2)
            mask_area = float(
                np.count_nonzero(np.any(src["gt"]["masks"][chosen] > 0.5, axis=0))
            )
            ratio = (h2 * w2 - mask_area - h1 * w1) / max(h * w, 1.0)
            if ratio > blank_ratio and h2 > 2 and w2 > 2:
                h2_new = rng.integers(max(int(0.5 * h1), 2), max(int(1.1 * h1), 3))
                w2_new = rng.integers(max(int(0.5 * w1), 2), max(int(1.1 * w1), 3))
                scale = min(h2_new / h2, w2_new / w2)

        slot = 0
        for i in chosen:
            box = src["gt"]["boxes"][i]
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            x1, y1 = max(x1, 0), max(y1, 0)
            x2, y2 = min(x2, src["image"].shape[1]), min(y2, src["image"].shape[0])
            if x2 - x1 < 2 or y2 - y1 < 2:
                continue
            crop = src["image"][y1:y2, x1:x2]
            mask = resize_image(src["gt"]["masks"][i], y2 - y1, x2 - x1)
            rgba = np.concatenate([crop, mask[..., None]], -1)
            out["patches"][slot] = resize_image(rgba, ps, ps)
            # paste at the source's own (possibly rescaled) coordinates —
            # SCP pads both images to a common canvas and composites in
            # place (_scp_src_to_dst, custom_copypaste.py:343-391)
            out["patch_boxes"][slot] = [v * scale for v in (x1, y1, x2, y2)]
            out["patch_classes"][slot] = src["gt"]["classes"][i]
            out["patch_valid"][slot] = True
            out["patch_flip"][slot] = rng.random() < 0.5
            out["patch_filenames"][slot] = (
                f"scp:{self.dataset[idxs[0]].get('file_name', idxs[0])}#{int(i)}"
            )[:256]
            slot += 1
            if slot >= max_pastes:
                break
        return out

    def __call__(self, record: dict, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        sample = self.mapper(record, rng)
        ps = self.pool.patch_size if self.pool else self.cfg.DATALOADER.PATCH_SIZE
        mp = self.max_pastes

        method = self.copy_method
        if method == "both" or method.startswith("p:"):
            method = "self_copy" if rng.random() < self.self_copy_prob else "syn_copy"

        if method == "syn_copy" and self.pool is not None:
            patches = self.pool.make_paste_sample(rng, mp, sample_type=self.sample_type)
            if self.cfg.INPUT.SEPARATE_SYN:
                # synthetic instances get their own class ids (+num_classes,
                # BSGAL custom_build_copypaste_mapper.py:505-508)
                n_base = self.cfg.MODEL.ROI_HEADS.NUM_CLASSES // 2
                patches["patch_classes"] = patches["patch_classes"] + n_base
        elif method == "self_copy" and self.dataset:
            patches = self._self_copy_patches(
                rng, mp, ps,
                dst_gt=sample.get("gt"),
                dst_size=tuple(sample.get("image_size", sample["image"].shape[:2])),
            )
        else:
            patches = _empty_patches(mp, ps)
        sample.update(patches)
        # uniform batch schema across the rotate/pool/self-copy paths
        sample.setdefault("patch_angle", np.zeros((mp,), np.float32))
        return sample


def _empty_patches(max_pastes: int, ps: int) -> Dict[str, np.ndarray]:
    return {
        "patches": np.zeros((max_pastes, ps, ps, 4), np.float32),
        "patch_boxes": np.zeros((max_pastes, 4), np.float32),
        "patch_classes": np.zeros((max_pastes,), np.int32),
        "patch_valid": np.zeros((max_pastes,), bool),
        "patch_flip": np.zeros((max_pastes,), bool),
        "patch_filenames": np.full((max_pastes,), "", dtype="<U256"),
    }
