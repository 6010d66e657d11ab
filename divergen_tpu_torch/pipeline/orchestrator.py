"""Pipeline-overlap orchestration (torch port): generation → SAM → CLIP-filter
producers feeding the trainer's instance pool while train steps run.

Counterpart of ``divergen_tpu/pipeline/orchestrator.py``; host code, numpy
and threads:

- ``InstanceProducer`` (background thread): per category, generate a batch,
  take corner-prompt SAM masks, score with CLIP and threshold, then push the
  accepted RGBA patches into the ``LivePool``. The three stages are callbacks.
- ``LivePool``: a thread-safe, capacity-bounded instance pool; the copy-paste
  mapper samples from it.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _resize_bilinear(rgba: np.ndarray, size: int) -> np.ndarray:
    """(h, w, C) float → (size, size, C), bilinear with half-pixel centers and
    no antialiasing (OpenCV's default ``resize``)."""
    x = torch.from_numpy(np.ascontiguousarray(rgba)).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
    return x[0].permute(1, 2, 0).contiguous().numpy()


class LivePool:
    """Thread-safe growing RGBA pool with InstPool's sampling surface."""

    def __init__(self, patch_size: int = 128, capacity_per_cat: int = 512,
                 train_size: Tuple[int, int] = (896, 896), max_samples: int = 20,
                 size_priors: Optional[Dict] = None):
        self._lock = threading.Lock()
        self._store: Dict[int, List[np.ndarray]] = {}
        self.patch_size = patch_size
        self.capacity = capacity_per_cat
        self.train_size = train_size
        self.max_samples = max_samples
        self.size_priors = size_priors or {}
        self.order_rng = None
        self.total_added = 0

    # -- producer side ---------------------------------------------------
    def add(self, cat_id: int, rgba: np.ndarray) -> None:
        """rgba (ps, ps, 4), rgb 0..255, alpha in [0,1]."""
        with self._lock:
            lst = self._store.setdefault(int(cat_id), [])
            if len(lst) >= self.capacity:
                lst.pop(0)  # ring: oldest instances retire
            lst.append(rgba.astype(np.float32))
            self.total_added += 1

    def counts(self) -> Dict[int, int]:
        with self._lock:
            return {c: len(v) for c, v in self._store.items()}

    # -- consumer side (CopyPasteMapper interface) ------------------------
    def make_paste_sample(self, rng: np.random.Generator, max_pastes: int,
                          sample_type: str = "random", cids=None,
                          flip_prob: float = 0.5) -> Dict[str, np.ndarray]:
        ps = self.patch_size
        out = {
            "patches": np.zeros((max_pastes, ps, ps, 4), np.float32),
            "patch_boxes": np.zeros((max_pastes, 4), np.float32),
            "patch_classes": np.zeros((max_pastes,), np.int32),
            "patch_valid": np.zeros((max_pastes,), bool),
            "patch_flip": np.zeros((max_pastes,), bool),
        }
        with self._lock:
            cats = [c for c, v in self._store.items() if v]
            if not cats:
                return out
            num = min(int(rng.integers(0, self.max_samples + 1)), max_pastes)
            img_h, img_w = self.train_size
            for slot in range(num):
                c = cats[int(rng.integers(0, len(cats)))]
                inst = self._store[c][int(rng.integers(0, len(self._store[c])))]
                out["patches"][slot] = inst
                scale = rng.uniform(0.1, 0.5)
                tw = th = max(int(scale * min(img_h, img_w)), 8)
                cx, cy = rng.integers(0, img_w), rng.integers(0, img_h)
                out["patch_boxes"][slot] = [cx - tw / 2, cy - th / 2, cx + tw / 2, cy + th / 2]
                out["patch_classes"][slot] = c
                out["patch_valid"][slot] = True
                out["patch_flip"][slot] = rng.random() < flip_prob
        return out


class InstanceProducer(threading.Thread):
    """Background gen→mask→filter loop.

    generate_fn(cat_id, rng) → (B, H, W, 3) uint8 images
    mask_fn(images) → (B, H, W) bool instance masks
    score_fn(images, masks, cat_id) → (B,) float CLIP scores
    """

    def __init__(
        self,
        pool: LivePool,
        categories: Sequence[int],
        generate_fn: Callable,
        mask_fn: Callable,
        score_fn: Optional[Callable] = None,
        clip_threshold: float = 0.2,
        area_range: Tuple[float, float] = (0.01, 0.95),
        seed: int = 0,
        max_rounds: Optional[int] = None,
    ):
        super().__init__(daemon=True)
        self.pool = pool
        self.categories = list(categories)
        self.generate_fn = generate_fn
        self.mask_fn = mask_fn
        self.score_fn = score_fn
        self.clip_threshold = clip_threshold
        self.area_range = area_range
        self.rng = np.random.default_rng(seed)
        self.max_rounds = max_rounds
        self.stop_event = threading.Event()
        self.produced = 0
        self.rejected = 0

    def run(self):
        rounds = 0
        while not self.stop_event.is_set():
            if self.max_rounds is not None and rounds >= self.max_rounds:
                break
            for cat in self.categories:
                if self.stop_event.is_set():
                    break
                images = self.generate_fn(cat, self.rng)  # (B,H,W,3)
                masks = np.asarray(self.mask_fn(images))  # (B,H,W) bool
                scores = (
                    np.asarray(self.score_fn(images, masks, cat))
                    if self.score_fn
                    else np.full(len(images), np.inf)
                )
                for img, m, s in zip(np.asarray(images), masks, scores):
                    frac = float(m.mean())
                    if s < self.clip_threshold or not (
                        self.area_range[0] <= frac <= self.area_range[1]
                    ):
                        self.rejected += 1
                        continue
                    ys, xs = np.where(m)
                    if len(ys) == 0:
                        self.rejected += 1
                        continue
                    crop = img[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
                    mc = m[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
                    rgba = np.dstack([crop.astype(np.float32), mc.astype(np.float32)])
                    ps = self.pool.patch_size
                    rgba = _resize_bilinear(rgba, ps)
                    self.pool.add(cat, rgba)
                    self.produced += 1
            rounds += 1

    def stop(self):
        self.stop_event.set()
