"""Dataset mapper, the test-time half: record dict → padded canvas sample.

Counterpart of ``divergen_tpu/data/dataset_mapper.py`` with
``is_train=False``: the image read from its file (PNG only, through
``utils/png.py``), resized by ``ResizeShortestEdge(MIN_SIZE_TEST,
MAX_SIZE_TEST)``, placed at the top left of a (TEST_SIZE, TEST_SIZE)
float32 canvas (a resized image larger than the canvas is cropped), with
``image_size`` its (h, w) on the canvas and the transform for the inverse
box mapping. The train half (augmentations, instance targets, box-frame
masks) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.png import read_rgb
from .transforms import ResizeShortestEdge, apply_augmentations

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG file. Any other format raises: JPEG (what
    LVIS and COCO ship) is not yet supported, as the port decodes images
    without OpenCV or PIL."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head != _PNG_SIGNATURE:
        kind = "JPEG" if head[:2] == b"\xff\xd8" else "not a PNG"
        raise ValueError(f"{path}: {kind}; the port reads PNG images only (JPEG input is not "
                         "yet supported); convert the image to PNG")
    return read_rgb(path)


class DatasetMapper:
    """cfg-driven mapper. ``DatasetMapper(cfg, is_train=False)(record)`` →
    {image (C, C, 3) float32 RGB on the test canvas, image_size (2,) int32
    (h, w) of the image on it, gt (empty), image_id, tfms}."""

    def __init__(self, cfg, is_train: bool = True):
        if is_train:
            raise NotImplementedError("the train half of DatasetMapper (augmentations, "
                                      "instance targets) is not yet ported")
        self.is_train = False
        self.max_instances = cfg.DATALOADER.MAX_INSTANCES
        self.mask_side = cfg.MODEL.ROI_MASK_HEAD.GT_SIDE
        mask_head = cfg.MODEL.ROI_MASK_HEAD
        self.sem_seg_stride = mask_head.SEM_SEG_STRIDE if mask_head.SEM_SEG_ON else 0
        self.canvas = cfg.INPUT.TEST_SIZE
        self.augs = [ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)]

    def __call__(self, record: dict, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        img = (record["image_new"] if "image_new" in record
               else read_image(record["file_name"])).astype(np.uint8)
        img_aug, tfms = apply_augmentations(self.augs, img, rng)
        h, w = img_aug.shape[:2]
        canvas = self.canvas
        out_img = np.zeros((canvas, canvas, 3), np.float32)
        out_img[: min(h, canvas), : min(w, canvas)] = img_aug[:canvas, :canvas]
        n_cap, side = self.max_instances, self.mask_side
        gt = {
            "boxes": np.zeros((n_cap, 4), np.float32),
            "classes": np.zeros((n_cap,), np.int32),
            "valid": np.zeros((n_cap,), bool),
            "masks": np.zeros((n_cap, side, side), np.float32),
            "instance_source": np.zeros((n_cap,), np.int32),
        }
        if self.sem_seg_stride:  # no annotations at test time: an empty target
            gt["sem_seg"] = np.zeros((canvas // self.sem_seg_stride,) * 2, np.float32)
        return {
            "image": out_img,
            "image_size": np.array([min(h, canvas), min(w, canvas)], np.int32),
            "gt": gt,
            "image_id": record.get("image_id", -1),
            "tfms": tfms,
        }
