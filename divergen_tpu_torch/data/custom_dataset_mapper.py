"""Multi-dataset mapper: per-dataset annotation types + tar-file images.

Counterpart of ``divergen_tpu/data/custom_dataset_mapper.py``: the port's
``DatasetMapper`` plus ``ann_type`` per dataset source ('box' datasets have
boxes but no masks, so mask targets default to the full box; 'image'
datasets carry only image-level labels, Detic's weak supervision) and
ImageNet-in-tar records (``tar_index``) decoded from ``data/tar_dataset.py``
with a whole-image sample. The detector takes an image-labelled batch
through ``CustomRCNN.forward(ann_type=…)``; ``do_train`` routes none there,
in either package (it never passes ``ann_type``). The JAX module's sources:
``DiverGen/divergen/data/custom_dataset_mapper.py:23-279``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .dataset_mapper import DatasetMapper
from .tar_dataset import DiskTarDataset
from .transforms import apply_augmentations


class CustomDatasetMapper(DatasetMapper):
    def __init__(self, cfg, is_train: bool = True,
                 tar_dataset: Optional[DiskTarDataset] = None):
        super().__init__(cfg, is_train)
        self.dataset_ann: List[str] = list(cfg.DATALOADER.DATASET_ANN)
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        if tar_dataset is None and cfg.DATALOADER.USE_TAR_DATASET and is_train:
            # ImageNet-21k-in-tar path (ref custom_dataset_mapper.py:59-67):
            # TARFILE_PATH is an .npy list of per-class tar files
            tar_paths = [str(p) for p in np.load(cfg.DATALOADER.TARFILE_PATH)]
            tar_dataset = DiskTarDataset(tar_paths, index_dir=cfg.DATALOADER.TAR_INDEX_DIR)
        self.tar_dataset = tar_dataset

    def __call__(self, record: dict, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        src = int(record.get("dataset_source", 0))
        ann_type = self.dataset_ann[src] if src < len(self.dataset_ann) else "box"

        if "tar_index" in record and self.tar_dataset is not None:
            # ImageNet-in-tar record: decode from the tar and map the whole
            # image without instance annotations
            img = self.tar_dataset[int(record["tar_index"])]
            h, w = img.shape[:2]
            record = dict(record)
            record.setdefault("height", h)
            record.setdefault("width", w)
            sample = self._map_with_image(record, img, rng)
        else:
            sample = super().__call__(record, rng)

        sample["ann_type"] = ann_type
        sample["dataset_source"] = src
        # image-level labels (Detic weak supervision): multi-hot over classes
        labels = np.zeros((self.num_classes,), np.float32)
        for cid in record.get("pos_category_ids", []):
            if 0 <= cid < self.num_classes:
                labels[cid] = 1.0
        if ann_type == "image" and not record.get("pos_category_ids"):
            for ann in record.get("annotations", []):
                labels[ann["category_id"]] = 1.0
        sample["image_labels"] = labels
        if ann_type == "image":
            # no instance supervision from image-labeled datasets
            sample["gt"]["valid"][:] = False
        return sample

    def _map_with_image(self, record: dict, img: np.ndarray, rng) -> dict:
        img_aug, tfms = apply_augmentations(self.augs, img.astype(np.uint8), rng)
        h, w = img_aug.shape[:2]
        canvas = self.canvas
        out_img = np.zeros((canvas, canvas, 3), np.float32)
        out_img[: min(h, canvas), : min(w, canvas)] = img_aug[:canvas, :canvas]
        n_cap = self.max_instances
        side = self.mask_side
        gt = {
            "boxes": np.zeros((n_cap, 4), np.float32),
            "classes": np.zeros((n_cap,), np.int32),
            "valid": np.zeros((n_cap,), bool),
            "masks": np.zeros((n_cap, side, side), np.float32),
            "instance_source": np.zeros((n_cap,), np.int32),
        }
        return {
            "image": out_img,
            "image_size": np.array([min(h, canvas), min(w, canvas)], np.int32),
            "gt": gt,
            "image_id": record.get("image_id", -1),
            "tfms": tfms,
        }
