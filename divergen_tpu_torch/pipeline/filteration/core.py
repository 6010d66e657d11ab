"""Filtration stage core: batched CLIP inference + artifact IO (torch).

Counterpart of ``divergen_tpu/pipeline/filteration/core.py``: CLIP ViT-L/14
embeddings for LVIS crops and masked generated images, cosine similarity with
the total.json / total.csv pivot, masked image × "a photo of a single {c}"
text score with the mask-area fraction, and the avg ≥ threshold keep list.
The towers run on a padded fixed-size batch on the encoder's device; features
are stored as ``.npy``. Images are decoded by ``utils.image_io`` (PNG or
baseline JPEG, the pixels of ``cv2.imread``) and resized with
``F.interpolate``: bicubic there has the a = −0.75 kernel of OpenCV's
``INTER_CUBIC``, which rounds its 8-bit arithmetic differently (a gray level
or two per pixel).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.dist import rank_world
from ...utils.image_io import read_gray, read_rgb


# ---------------- host image prep ----------------
def clip_preprocess_np(img: np.ndarray, size: int = 224) -> np.ndarray:
    """CLIP preprocess: resize shortest edge (bicubic) + center crop; returns
    float RGB 0..255 (size, size, 3), rounded to whole gray levels when the
    input is uint8, as an 8-bit resize would."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = max(size, int(round(h * scale))), max(size, int(round(w * scale)))
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False)
    if img.dtype == np.uint8:
        x = x.round().clamp(0, 255)
    top, left = (nh - size) // 2, (nw - size) // 2
    return x[0, :, top: top + size, left: left + size].permute(1, 2, 0).contiguous().numpy()


def load_masked_image(
    path: str, mask_path: Optional[str] = None, background: str = "zero", size: int = 224
) -> Tuple[np.ndarray, float]:
    """Generated image with its background suppressed (zeroed for features,
    whitened for the CLIP score). Returns (img, mask_frac)."""
    img = read_rgb(path)
    frac = 1.0
    if mask_path and os.path.exists(mask_path):
        mask = read_gray(mask_path)
        if mask.shape[:2] != img.shape[:2]:  # nearest: source index = floor(dst · src/dst)
            ys = np.arange(img.shape[0]) * mask.shape[0] // img.shape[0]
            xs = np.arange(img.shape[1]) * mask.shape[1] // img.shape[1]
            mask = mask[ys][:, xs]
        on = mask > 127
        frac = float(on.mean())
        fill = 255 if background == "white" else 0
        img = np.where(on[..., None], img, fill).astype(np.uint8)
    return clip_preprocess_np(img, size), frac


# ---------------- device towers ----------------
class ClipEncoder:
    """CLIP towers with a fixed image batch size (pad and slice).

    ``params`` is ``{"vision": tree, "text": tree}`` in the layout of
    ``utils.torch_weights.load_clip_params``; without it the towers draw
    random weights from ``rng_seed``."""

    def __init__(self, model_name: str = "ViT-L/14", batch: int = 64,
                 params=None, rng_seed: int = 0, image_size: int = 224, device=None):
        from ...modeling.layers import flax_init_
        from ...modeling.text.clip import build_clip
        from ...utils.convert import params_from_jax
        from ...utils.dist import entry_device

        self.device = entry_device(device)
        self.batch = batch
        self.vision, self.text = build_clip(model_name, image_size=image_size,
                                            device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device)
            flax_init_(self.vision, gen.manual_seed(rng_seed))
            flax_init_(self.text, gen.manual_seed(rng_seed))
        else:
            self.vision.load_state_dict(params_from_jax(params["vision"]))
            self.text.load_state_dict(params_from_jax(params["text"]))
        self.vision.eval()
        self.text.eval()

    @torch.inference_mode()
    def encode_images(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) RGB 0..255 → (N, D) normalized, padded batching."""
        from ...modeling.text.clip import normalize, preprocess_images

        out = []
        for ofs in range(0, len(images), self.batch):
            chunk = torch.as_tensor(images[ofs: ofs + self.batch]).to(self.device)
            pad = self.batch - len(chunk)
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
            emb = normalize(self.vision(preprocess_images(chunk)))
            out.append(emb[: len(images) - ofs].float().cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 1))

    @torch.inference_mode()
    def encode_texts(self, tokens: np.ndarray) -> np.ndarray:
        from ...modeling.text.clip import normalize

        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        return normalize(self.text(toks)).float().cpu().numpy()


class DinoEncoder:
    """The DINOv2 image tower of ``--method dinov2``: ``modeling/backbone/
    dinov2.py:DinoV2`` (``model_name`` one of vits14, vitb14, vitl14, vitg14)
    with the ``encode_images`` interface of ``ClipEncoder``; embeddings are
    L2-normalized (norm at least 1e-8) for the shared cosine similarity, and
    the last chunk is padded to ``batch`` with zero images. ``params`` is a
    DINOv2 tree in the JAX module's layout; without it the tower draws random
    weights from ``rng_seed``. ``dtype`` is the tower's compute dtype
    (float32, as the JAX encoder runs it, unless the caller asks for
    another)."""

    def __init__(self, model_name: str = "vitg14", batch: int = 64, params=None,
                 rng_seed: int = 0, image_size: int = 224, device=None,
                 dtype=torch.float32):
        from ...modeling.backbone.dinov2 import DinoV2
        from ...modeling.layers import flax_init_
        from ...utils.convert import params_from_jax
        from ...utils.dist import entry_device

        self.device = entry_device(device)
        self.batch = batch
        self.model = DinoV2.from_name(model_name, image_size=image_size, dtype=dtype,
                                      device=self.device)
        if params is None:
            flax_init_(self.model, torch.Generator(device=self.device).manual_seed(rng_seed))
        else:
            self.model.load_state_dict(params_from_jax(params))
        self.model.eval()

    @torch.inference_mode()
    def encode_images(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) RGB 0..255 → (N, D) normalized, padded batching."""
        from ...modeling.backbone.dinov2 import dinov2_preprocess

        out = []
        for ofs in range(0, len(images), self.batch):
            chunk = torch.as_tensor(np.asarray(images[ofs: ofs + self.batch])).to(self.device)
            pad = self.batch - len(chunk)
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
            feats = self.model(dinov2_preprocess(chunk))
            emb = feats / torch.linalg.norm(feats, dim=-1, keepdim=True).clamp(min=1e-8)
            out.append(emb[: len(images) - ofs].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 1))


def cosine_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Similarity of normalized features."""
    return a @ b.T


# ---------------- artifact IO (bit-comparable formats) ----------------
def dict_to_csv(total: Dict[str, Dict[str, float]], out_path: str) -> None:
    """total.csv pivot."""
    cols = list(total[next(iter(total))].keys()) if total else []
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["lvis"] + cols + ["avg"])
        avgs = []
        for k, inner in total.items():
            vals = [inner[c] for c in cols]
            avg = sum(vals) / len(vals) if vals else 0
            avgs.append(avg)
            w.writerow([k] + vals + [avg])
        w.writerow(["avg"] + [sum(avgs) / len(avgs) if avgs else 0])


def filename_pivot(total: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """{lvis: {gen: sim}} → {gen: {lvis: sim}}."""
    out: Dict[str, Dict[str, float]] = {}
    for lvis_f, inner in total.items():
        for gen_f, sim in inner.items():
            out.setdefault(gen_f, {})[lvis_f] = sim
    return out


def filename_dict_to_csv(fd: Dict[str, Dict[str, float]], out_path: str) -> None:
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        cols = list(fd[next(iter(fd))].keys()) if fd else []
        w.writerow(["gen"] + cols + ["avg"])
        for k, inner in fd.items():
            vals = [inner.get(c, 0.0) for c in cols]
            avg = sum(vals) / len(vals) if vals else 0
            w.writerow([k] + vals + [avg])


def threshold_filter(fd: Dict[str, Dict[str, float]], threshold: float) -> Dict[str, float]:
    """gen files whose avg similarity ≥ threshold."""
    out = {}
    for gen_f, inner in fd.items():
        vals = list(inner.values())
        avg = sum(vals) / len(vals) if vals else 0
        if avg >= threshold:
            out[gen_f] = avg
    return out


def shard_indices(n: int, rank: Optional[int] = None, world: Optional[int] = None) -> List[int]:
    """The ``i % world_size == rank`` work split."""
    if rank is None:
        rank, world = rank_world()
    return [i for i in range(n) if i % world == rank]
