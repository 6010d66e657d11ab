"""Dataset mapper: record dict → device-ready padded sample (numpy).

Counterpart of ``divergen_tpu/data/dataset_mapper.py``, both halves, without
OpenCV: the image read from its file (PNG only, through ``utils/png.py``),
resized by ``data/transforms.py:resize_image`` (``F.interpolate``; on uint8
within one level of ``cv2.resize``), polygons rasterized by the native
``fill_polygon`` (the pixels of ``cv2.fillPoly``) and RLE crops resized in
float32 (``INTER_LINEAR`` up to rounding). The JAX module's sources:
``DiverGen/divergen/data/dataset_mapper.py:30-256`` (custom DatasetMapper
fork) + detectron2 ``detection_utils`` (annotations→Instances, image IO).

The output is a fixed-capacity padded sample: ``image`` on a square canvas
(TRAIN_SIZE or TEST_SIZE; a resized image larger than the canvas is
cropped), instance arrays padded to ``DATALOADER.MAX_INSTANCES`` with a
validity mask, and gt masks stored as box-frame ``(GT_SIDE, GT_SIDE)`` crops
(see structures/masks.py mask_target_in_box) rather than ragged full-image
bitmasks. Training: ``EfficientDetResizeCrop`` (or ``ResizeShortestEdge``)
and ``RandomFlip`` drawn from the caller's ``np.random.Generator`` in the
JAX package's order; test: ``ResizeShortestEdge(MIN_SIZE_TEST,
MAX_SIZE_TEST)`` and no annotations. An RLE mask is cropped from the
untransformed image in the transformed box (the JAX package's
approximation, kept).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import native
from ..utils.mask_codec import rle_decode
from ..utils.png import read_rgb
from .transforms import (
    EfficientDetResizeCrop,
    RandomFlip,
    ResizeShortestEdge,
    apply_augmentations,
    resize_image,
)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG file. Any other format raises: JPEG (what
    LVIS and COCO ship) is not yet supported, as the port decodes images
    without OpenCV or PIL. A missing file raises ``FileNotFoundError``, which
    the train loader skips."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head != _PNG_SIGNATURE:
        kind = "JPEG" if head[:2] == b"\xff\xd8" else "not a PNG"
        raise ValueError(f"{path}: {kind}; the port reads PNG images only (JPEG input is not "
                         "yet supported); convert the image to PNG")
    return read_rgb(path)


def _boxes_xywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    out = b.astype(np.float32).copy()
    out[:, 2:] += out[:, :2]
    return out


def _fill(mask: np.ndarray, pts: np.ndarray) -> None:
    """``cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)``."""
    native.fill_polygon(mask, np.round(pts).astype(np.int32).astype(np.int64))


def rasterize_box_frame(segm, box: np.ndarray, side: int) -> np.ndarray:
    """Rasterize a COCO segmentation directly into its box frame at SxS.

    Equivalent of full-image rasterize + BitMasks.crop_and_resize
    (detectron2 masks.py:208-230), skipping the full-size intermediate.
    """
    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    if isinstance(segm, dict):  # RLE
        full = rle_decode(segm).astype(np.uint8)
        xi1, yi1 = int(np.floor(x1)), int(np.floor(y1))
        xi2, yi2 = int(np.ceil(x2)), int(np.ceil(y2))
        crop = full[max(yi1, 0) : max(yi2, 0), max(xi1, 0) : max(xi2, 0)]
        if crop.size == 0:
            return np.zeros((side, side), np.float32)
        return resize_image(crop.astype(np.float32), side, side)
    mask = np.zeros((side, side), np.uint8)
    for poly in segm:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        pts[:, 0] = (pts[:, 0] - x1) / w * side
        pts[:, 1] = (pts[:, 1] - y1) / h * side
        _fill(mask, pts)
    return mask.astype(np.float32)


class DatasetMapper:
    """cfg-driven mapper. __call__(record, rng) → sample dict:

    image (Ht,Wt,3) float32 RGB on the padded canvas,
    image_size (2,) int32 actual (h,w),
    gt: boxes (N,4) f32, classes (N,) i32, valid (N,) bool,
        masks (N,S,S) f32 box-frame, instance_source (N,) i32,
        with ``SEM_SEG_ON`` sem_seg (C/stride, C/stride) f32,
    image_id, and the transforms for eval's inverse box mapping (tfms).
    """

    def __init__(self, cfg, is_train: bool = True):
        self.is_train = is_train
        self.max_instances = cfg.DATALOADER.MAX_INSTANCES
        self.mask_side = cfg.MODEL.ROI_MASK_HEAD.GT_SIDE
        mask_head = cfg.MODEL.ROI_MASK_HEAD
        self.sem_seg_stride = mask_head.SEM_SEG_STRIDE if mask_head.SEM_SEG_ON else 0
        if is_train:
            self.canvas = cfg.INPUT.TRAIN_SIZE
            augs: List = []
            if cfg.INPUT.CUSTOM_AUG == "EfficientDetResizeCrop":
                augs.append(EfficientDetResizeCrop(cfg.INPUT.TRAIN_SIZE,
                                                   tuple(cfg.INPUT.SCALE_RANGE)))
            else:
                augs.append(ResizeShortestEdge(min(cfg.INPUT.MIN_SIZE_TRAIN),
                                               cfg.INPUT.MAX_SIZE_TRAIN))
            if cfg.INPUT.RANDOM_FLIP != "none":
                augs.append(RandomFlip(0.5))
            self.augs = augs
        else:
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
        annos = record.get("annotations", []) if self.is_train else []
        sem = None
        if self.sem_seg_stride:
            sem = np.zeros((canvas // self.sem_seg_stride,) * 2, np.uint8)
        slot = 0
        for ann in annos:
            if slot >= n_cap:
                break
            box = _boxes_xywh_to_xyxy(np.asarray(ann["bbox"], np.float32)[None])[0]
            tbox = tfms.apply_box(box[None])[0]
            tbox[[0, 2]] = np.clip(tbox[[0, 2]], 0, w)
            tbox[[1, 3]] = np.clip(tbox[[1, 3]], 0, h)
            if tbox[2] - tbox[0] < 1 or tbox[3] - tbox[1] < 1:
                continue
            segm = ann.get("segmentation")
            if segm is not None and not isinstance(segm, dict):
                # transform polygon coords, rasterize in the transformed box
                tpolys = []
                for poly in segm:
                    pts = np.asarray(poly, np.float64).reshape(-1, 2)
                    tpolys.append(tfms.apply_coords(pts).reshape(-1))
                mask = rasterize_box_frame(tpolys, tbox, side)
            elif segm is not None:
                mask = rasterize_box_frame(segm, tbox, side)  # RLE: approx (no tfm)
            else:
                mask = np.ones((side, side), np.float32)
            if sem is not None and segm is not None and not isinstance(segm, dict):
                for poly in segm:
                    pts = np.asarray(poly, np.float64).reshape(-1, 2)
                    _fill(sem, tfms.apply_coords(pts) / self.sem_seg_stride)
            gt["boxes"][slot] = tbox
            gt["classes"][slot] = ann["category_id"]
            gt["valid"][slot] = True
            gt["masks"][slot] = mask
            slot += 1

        if sem is not None:
            gt["sem_seg"] = sem.astype(np.float32)
        return {
            "image": out_img,
            "image_size": np.array([min(h, canvas), min(w, canvas)], np.int32),
            "gt": gt,
            "image_id": record.get("image_id", -1),
            "tfms": tfms,
        }
