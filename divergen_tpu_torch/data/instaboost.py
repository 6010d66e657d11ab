"""Functional InstaBoost (host-side numpy, OpenCV's routines from
``native/``).

Counterpart of ``divergen_tpu/data/instaboost.py``: the same
``np.random.Generator`` draws in the same order, with ``cv2.fillPoly``,
``inpaint`` (Telea), ``warpAffine``, ``cvtColor`` RGB <-> HSV and ``dilate``
taken from ``native/`` (``fill_polygon``, ``inpaint_telea``, ``warp_affine``,
``rgb_to_hsv`` / ``hsv_to_rgb``, ``dilate``). The JAX module re-implements the
transform subset the reference configures through the external
``instaboostfast`` package (``DiverGen/divergen/data/custom_build_copypaste_mapper.py:596-666``):
per-instance affine jitter (action in {normal, horizontal, skip} with given
probabilities, scale ~ U(*scale*), translation ~ U(-dx, dx) x U(-dy, dy),
rotation ~ U(*theta*) degrees) over an inpainted background, polygons and
boxes transformed with it, and the optional appearance-consistency heatmap
placement (``hflag``).

Annotations are COCO/LVIS-style dicts: ``bbox`` [x, y, w, h],
``segmentation`` polygon lists, ``category_id``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native


class InstaBoostConfig:
    def __init__(
        self,
        action_candidate: Sequence[str] = ("normal", "horizontal", "skip"),
        action_prob: Sequence[float] = (1, 0, 0),
        scale: Tuple[float, float] = (0.8, 1.2),
        dx: float = 15,
        dy: float = 15,
        theta: Tuple[float, float] = (-1, 1),
        color_prob: float = 0.5,
        hflag: bool = False,
    ):
        self.action_candidate = tuple(action_candidate)
        p = np.asarray(action_prob, np.float64)
        self.action_prob = p / max(p.sum(), 1e-9)
        self.scale = scale
        self.dx = dx
        self.dy = dy
        self.theta = theta
        self.color_prob = color_prob
        # heatmap-guided placement (InstaBoost ICCV'19 §3.2 "appearance
        # consistency heatmap"). The reference configs never enable it
        # (custom_build_copypaste_mapper.py:615 passes hflag=False), but the
        # instaboostfast surface exposes it, so it is implemented for parity.
        self.hflag = hflag


def _poly_mask(anns: Sequence[dict], h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    for ann in anns:
        for poly in ann.get("segmentation", []):
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            native.fill_polygon(m, np.round(pts).astype(np.int32).astype(np.int64))
    return m


def _affine(cx, cy, s, tx, ty, ang_deg, flip_x: Optional[float] = None) -> np.ndarray:
    """3x3 affine: (optional mirror about x=flip_x) then scale+rotate about
    (cx, cy) then translate."""
    c, si = np.cos(np.deg2rad(ang_deg)), np.sin(np.deg2rad(ang_deg))
    rot = np.array([[s * c, -s * si, 0], [s * si, s * c, 0], [0, 0, 1]])
    t_in = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    t_out = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]], np.float64)
    m = t_out @ rot @ t_in
    if flip_x is not None:
        mirror = np.array([[-1, 0, 2 * flip_x], [0, 1, 0], [0, 0, 1]], np.float64)
        m = m @ mirror
    return m


def _jitter_color(img, mask, rng):
    hsv = native.rgb_to_hsv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + rng.integers(-6, 7)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + rng.integers(-16, 17), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + rng.integers(-16, 17), 0, 255)
    out = native.hsv_to_rgb(hsv.astype(np.uint8))
    return np.where(mask[..., None] > 0, out, img)


def _heatmap_translation(
    img: np.ndarray,
    mask: np.ndarray,
    bbox: Sequence[float],
    rng: np.random.Generator,
    stride: int = 8,
    max_ring_px: int = 256,
) -> Tuple[float, float]:
    """Sample a (tx, ty) from the appearance-consistency heatmap.

    InstaBoost ICCV'19 §3.2: the background descriptor of an instance is its
    contour neighborhood — three dilation rings with decaying weights. A
    candidate center (on a ``stride`` grid where the instance still fits)
    scores by how closely the background under the *shifted* rings matches
    the rings at the original location; the heatmap is a softmax over the
    negative RGB distance, and the translation is drawn from it.
    """
    h, w = img.shape[:2]
    d1 = native.dilate(mask, (5, 5), iterations=1).astype(bool)
    d2 = native.dilate(mask, (5, 5), iterations=3).astype(bool)
    d3 = native.dilate(mask, (5, 5), iterations=6).astype(bool)
    rings = [d1 & ~mask.astype(bool), d2 & ~d1, d3 & ~d2]
    weights = (0.6, 0.3, 0.1)

    pys, pxs, pws, refs = [], [], [], []
    f = img.astype(np.float32)
    for ring, wgt in zip(rings, weights):
        ys, xs = np.nonzero(ring)
        if len(ys) == 0:
            continue
        if len(ys) > max_ring_px:
            sel = rng.choice(len(ys), max_ring_px, replace=False)
            ys, xs = ys[sel], xs[sel]
        pys.append(ys)
        pxs.append(xs)
        pws.append(np.full(len(ys), wgt / len(ys), np.float32))
        refs.append(f[ys, xs])
    if not pys:
        return 0.0, 0.0
    pys = np.concatenate(pys)
    pxs = np.concatenate(pxs)
    pws = np.concatenate(pws)
    refs = np.concatenate(refs)

    x, y, bw, bh = bbox
    cx, cy = x + bw / 2.0, y + bh / 2.0
    # candidate centers where the box stays in frame
    cxs = np.arange(bw / 2, w - bw / 2 + 1e-6, stride)
    cys = np.arange(bh / 2, h - bh / 2 + 1e-6, stride)
    if len(cxs) == 0 or len(cys) == 0:
        return 0.0, 0.0
    gx, gy = np.meshgrid(cxs, cys)
    dx = (gx - cx).ravel()
    dy = (gy - cy).ravel()
    # shifted ring coordinates per candidate, in bounded chunks: the full
    # (n_cand, n_px) index/gather tensors reach ~1 GB transient on a
    # 2048×1024 image (32k candidates × ~768 ring px), per instance, inside
    # dataloader workers — chunking bounds it to a few MB with identical
    # results
    dist = np.empty(len(dx), np.float32)
    chunk = max(1, (1 << 20) // max(len(pys), 1))
    for s in range(0, len(dx), chunk):
        e = s + chunk
        sy = np.clip(np.round(pys[None] + dy[s:e, None]).astype(np.int32), 0, h - 1)
        sx = np.clip(np.round(pxs[None] + dx[s:e, None]).astype(np.int32), 0, w - 1)
        diff = f[sy, sx] - refs[None]
        dist[s:e] = (np.square(diff).sum(-1) * pws[None]).sum(-1)
    # adaptive temperature: the mean distance — scale-free across images
    heat = np.exp(-dist / max(float(dist.mean()), 1e-6))
    heat /= heat.sum()
    pick = rng.choice(len(heat), p=heat)
    # continuous within the stride cell
    jx = rng.uniform(-stride / 2, stride / 2)
    jy = rng.uniform(-stride / 2, stride / 2)
    return float(dx[pick] + jx), float(dy[pick] + jy)


def get_new_data(
    anns: List[dict],
    img: np.ndarray,  # (H, W, 3) uint8 RGB
    cfg: InstaBoostConfig,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[dict], np.ndarray]:
    """instaboostfast.get_new_data equivalent: jitter every instance over an
    inpainted background; returns (new_anns, new_img)."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    union = _poly_mask(anns, h, w)
    if union.sum() == 0:
        return anns, img
    # restore the background behind the instances (matting stand-in)
    canvas = native.inpaint_telea(img, union > 0, 3)

    new_anns: List[dict] = []
    # paste big → small so small instances keep occluding big ones
    order = np.argsort([-(a["bbox"][2] * a["bbox"][3]) for a in anns])
    for idx in order:
        ann = anns[idx]
        m = _poly_mask([ann], h, w)
        action = rng.choice(len(cfg.action_candidate), p=cfg.action_prob)
        action = cfg.action_candidate[action]
        x, y, bw, bh = ann["bbox"]
        cx, cy = x + bw / 2.0, y + bh / 2.0
        if action == "skip":
            mat = np.eye(3)
        else:
            if cfg.hflag:
                tx, ty = _heatmap_translation(img, m, ann["bbox"], rng)
            else:
                tx = rng.uniform(-cfg.dx, cfg.dx)
                ty = rng.uniform(-cfg.dy, cfg.dy)
            mat = _affine(
                cx, cy,
                s=rng.uniform(*cfg.scale),
                tx=tx,
                ty=ty,
                ang_deg=rng.uniform(*cfg.theta),
                flip_x=cx if action == "horizontal" else None,
            )
        wimg = native.warp_affine(img, mat[:2], (w, h))
        wmask = native.warp_affine(m, mat[:2], (w, h), nearest=True)
        polys = []
        for poly in ann.get("segmentation", []):
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            pts = pts @ mat[:2, :2].T + mat[:2, 2]
            pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
            pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
            polys.append(pts.reshape(-1).tolist())
        all_pts = np.concatenate([np.asarray(p).reshape(-1, 2) for p in polys]) \
            if polys else np.zeros((0, 2))
        if wmask.sum() == 0 or len(all_pts) == 0:
            # jittered fully out of frame — keep the original placement
            # (the reference wraps get_new_data in try/except and falls back
            # to the unaugmented dict, :654-656)
            canvas = np.where(m[..., None] > 0, img, canvas)
            new_anns.append(ann)
            continue
        canvas = np.where(wmask[..., None] > 0, wimg, canvas)
        if rng.random() < cfg.color_prob:
            canvas = _jitter_color(canvas, wmask, rng)
        x0, y0 = all_pts.min(0)
        x1, y1 = all_pts.max(0)
        new = dict(ann)
        new["segmentation"] = polys
        new["bbox"] = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
        new["area"] = float(wmask.sum())
        if new["bbox"][2] <= 0 or new["bbox"][3] <= 0:
            continue  # reference drops degenerate boxes (:649-652)
        new_anns.append(new)
    return new_anns, canvas


class InstaBoost:
    """Reference-wrapper equivalent (custom_build_copypaste_mapper.py:596-666):
    frequency-bucket filtering via ``cid_to_freq``/``apply_freq``,
    ``aug_ratio`` gating, annotations + ``image_new`` update on the record."""

    def __init__(
        self,
        action_candidate=("normal", "horizontal", "skip"),
        action_prob=(1, 0, 0),
        scale=(0.8, 1.2),
        dx=15,
        dy=15,
        theta=(-1, 1),
        color_prob=0.5,
        hflag=False,
        aug_ratio=0.5,
        cid_to_freq: Optional[Dict[int, str]] = None,
        apply_freq: Sequence[str] = ("r", "c", "f"),
    ):
        self.cfg = InstaBoostConfig(
            action_candidate, action_prob, scale, dx, dy, theta, color_prob, hflag
        )
        self.aug_ratio = aug_ratio
        self.cid_to_freq = cid_to_freq or {}
        self.apply_freq = set(apply_freq)

    def __call__(self, record: dict, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        anns = [dict(a) for a in record.get("annotations", [])]
        boost = [a for a in anns
                 if self.cid_to_freq.get(a["category_id"], "f") in self.apply_freq]
        rest = [a for a in anns
                if self.cid_to_freq.get(a["category_id"], "f") not in self.apply_freq]
        if not boost or rng.random() >= self.aug_ratio:
            return record
        from .dataset_mapper import read_image

        img = (record["image_new"] if "image_new" in record
               else read_image(record["file_name"])).astype(np.uint8)
        try:
            boost, img = get_new_data(boost, img, self.cfg, rng)
        except Exception:  # reference: "failed at instaboost" fallback (:654)
            return record
        out = dict(record)
        out["annotations"] = boost + rest
        out["image_new"] = img
        return out
