"""Filtration stage CLIs (torch): six entry points sharing core.py.

Counterpart of ``divergen_tpu/pipeline/filteration/cli.py``, with the same
flags and artifact formats plus ``--device``:
- ``extract_features``: CLIP embeddings of per-category images, ``.npy``
- ``compute_similarity``: real × generated cosine similarity, total.json/csv
- ``filter_by_similarity``: avg ≥ threshold keep list
- ``clip_score``: masked image × "a photo of a single {category}" score,
  mask whitening, per-rank partial results merged by rank 0
- ``clean_pool``: the best segmentation method per image by CLIP score, the
  score, area and similarity filters, the RGBA bbox crop as PNG, the pool
  JSON that ``data/inst_pool.py`` reads (host only)
- ``lvis_crop``: per-annotation crops of an LVIS-format set (tight, square
  or padded box; white, black, box-blurred or original background) as PNG,
  the real-instance images ``extract_features`` embeds (host only)

Without a CLIP checkpoint the towers run on random weights: the artifact
plumbing still runs end to end. Images are read by ``utils/image_io.py``
(PNG or baseline JPEG, the pixels of ``cv2.imread``) and written as PNG: the
port reads RGB and writes RGB(A) where the JAX CLI's OpenCV reads BGR and
writes BGR(A), so the files hold the same pixels. ``--method dinov2
--dino_model vitg14`` embeds with ``core.DinoEncoder`` (float32, as in JAX).

    python -c "from divergen_tpu_torch.pipeline.filteration.cli import \\
        extract_features as f; raise SystemExit(f())" --in_dir samples/ \\
        --out_dir feats/ --mask_dir masks/
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from collections import defaultdict
from glob import glob
from typing import Dict, List

import numpy as np

from ...utils.dist import rank_world
from .core import (
    ClipEncoder,
    cosine_matrix,
    dict_to_csv,
    filename_dict_to_csv,
    filename_pivot,
    load_masked_image,
    shard_indices,
    threshold_filter,
)

_DEVICE_HELP = "torch device (default: cuda; without a card pass cpu, nothing falls back)"


def _encoder(args) -> ClipEncoder:
    if getattr(args, "method", "clip") == "dinov2":
        from .core import DinoEncoder

        return DinoEncoder(getattr(args, "dino_model", "vitg14"), batch=args.batch,
                           device=args.device or None)
    params = None
    if getattr(args, "clip_ckpt", ""):
        from ...utils.torch_weights import load_clip_params

        params = load_clip_params(args.clip_ckpt, args.model_name)
    return ClipEncoder(getattr(args, "model_name", "ViT-L/14"), batch=args.batch, params=params,
                       device=args.device or None)


# ---------------- 1. feature extraction ----------------
def extract_features(argv=None) -> int:
    p = argparse.ArgumentParser("get_image_feature")
    p.add_argument("--in_dir", required=True, help="per-category image dirs")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--mask_dir", default="", help="gen-image masks (background zeroed)")
    p.add_argument("--model_name", default="ViT-L/14")
    p.add_argument("--method", default="clip", choices=["clip", "dinov2"],
                   help="feature tower")
    p.add_argument("--dino_model", default="vitg14")
    p.add_argument("--clip_ckpt", default="")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dist", action="store_true")
    p.add_argument("--device", default="", help=_DEVICE_HELP)
    args = p.parse_args(argv)

    enc = _encoder(args)
    cats = sorted(os.listdir(args.in_dir))
    for ci in shard_indices(len(cats), *rank_world(args.dist)):
        cat = cats[ci]
        files = sorted(glob(os.path.join(args.in_dir, cat, "*")))
        out_cat = os.path.join(args.out_dir, cat)
        os.makedirs(out_cat, exist_ok=True)
        todo, outs = [], []
        for f in files:
            out_path = os.path.join(
                out_cat, os.path.basename(f).rsplit(".", 1)[0] + ".npy"
            )
            if os.path.exists(out_path):
                continue
            mask = (
                os.path.join(args.mask_dir, cat, os.path.basename(f).rsplit(".", 1)[0] + ".png")
                if args.mask_dir
                else None
            )
            img, _ = load_masked_image(f, mask, background="zero")
            todo.append(img)
            outs.append(out_path)
        if todo:
            feats = enc.encode_images(np.stack(todo))
            for feat, out_path in zip(feats, outs):
                np.save(out_path, feat)
    print("features done")
    return 0


# ---------------- 2. inter-similarity ----------------
def compute_similarity(argv=None) -> int:
    p = argparse.ArgumentParser("get_image_similarity_from_feature")
    p.add_argument("--lvis_feature_dir", required=True)
    p.add_argument("--gen_feature_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--category_map_json", default="", help="{cat_id: name} for gen dirs")
    p.add_argument("--dist", action="store_true")
    args = p.parse_args(argv)

    id2name = {}
    if args.category_map_json:
        with open(args.category_map_json) as f:
            id2name = json.load(f)
    cats = sorted(os.listdir(args.lvis_feature_dir))
    for ci in shard_indices(len(cats), *rank_world(args.dist)):
        cat = cats[ci]
        out_cat = os.path.join(args.out_dir, cat)
        os.makedirs(out_cat, exist_ok=True)
        json_path = os.path.join(out_cat, "total.json")
        csv_path = os.path.join(out_cat, "total.csv")
        if os.path.exists(csv_path):
            continue
        gen_cat = id2name.get(cat, cat)
        lvis_files = sorted(glob(os.path.join(args.lvis_feature_dir, cat, "*.npy")))
        gen_files = sorted(glob(os.path.join(args.gen_feature_dir, gen_cat, "*.npy")))
        if not lvis_files or not gen_files:
            continue
        lvis_feats = np.stack([np.load(f) for f in lvis_files])
        gen_feats = np.stack([np.load(f) for f in gen_files])
        sims = cosine_matrix(lvis_feats, gen_feats)  # (L, G)
        gen_names = [os.path.basename(f).replace(".npy", ".png") for f in gen_files]
        total = {}
        for li, lf in enumerate(lvis_files):
            lvis_name = os.path.basename(lf).replace(".npy", ".png")
            total[lvis_name] = {g: float(s) for g, s in zip(gen_names, sims[li])}
        with open(json_path, "w") as f:
            json.dump(total, f)
        dict_to_csv(total, csv_path)
    print("similarity done")
    return 0


# ---------------- 3. threshold filter ----------------
def filter_by_similarity(argv=None) -> int:
    p = argparse.ArgumentParser("filter_image_by_similarity")
    p.add_argument("--sim_dir", required=True, help="dir of per-category total.json")
    p.add_argument("--out_path", required=True)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--category_map_json", default="")
    p.add_argument("--save_filtered_out", action="store_true")
    args = p.parse_args(argv)

    id2name = {}
    if args.category_map_json:
        with open(args.category_map_json) as f:
            id2name = json.load(f)
    out_dict: Dict[str, Dict[str, float]] = {}
    dropped: Dict[str, Dict[str, float]] = {}
    for cat in sorted(os.listdir(args.sim_dir)):
        jp = os.path.join(args.sim_dir, cat, "total.json")
        if not os.path.exists(jp):
            continue
        with open(jp) as f:
            total = json.load(f)
        fd = filename_pivot(total)
        filename_dict_to_csv(fd, os.path.join(args.sim_dir, cat, "total_filename.csv"))
        with open(os.path.join(args.sim_dir, cat, "total_filename.json"), "w") as f:
            json.dump(fd, f)
        name = id2name.get(cat, cat)
        kept = threshold_filter(fd, args.threshold)
        out_dict[name] = kept
        if args.save_filtered_out:
            dropped[name] = {
                k: sum(v.values()) / max(len(v), 1)
                for k, v in fd.items()
                if k not in kept
            }
    os.makedirs(os.path.dirname(args.out_path) or ".", exist_ok=True)
    base = args.out_path.rsplit(".", 1)[0]
    with open(f"{base}_thres_{args.threshold}.csv", "w", newline="") as f:
        w = csv.writer(f)
        for name, kept in out_dict.items():
            for fn, avg in kept.items():
                w.writerow([name, fn, avg])
    with open(f"{base}_thres_{args.threshold}.json", "w") as f:
        json.dump(out_dict, f)
    if args.save_filtered_out:
        with open(f"{base}_thres_{args.threshold}_filtered_out.json", "w") as f:
            json.dump(dropped, f)
    print("filter done")
    return 0


# ---------------- 4. CLIP score ----------------
def clip_score(argv=None) -> int:
    p = argparse.ArgumentParser("get_clip_score")
    p.add_argument("--in_dir", required=True, help="per-category gen images")
    p.add_argument("--mask_dir", required=True, help="seg-method mask dir")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--model_name", default="ViT-L/14")
    p.add_argument("--clip_ckpt", default="")
    p.add_argument("--bpe_path", default="")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dist", action="store_true")
    p.add_argument("--device", default="", help=_DEVICE_HELP)
    args = p.parse_args(argv)

    enc = _encoder(args)
    from ...modeling.text.tokenizer import SimpleTokenizer

    tok = (
        SimpleTokenizer(bpe_path=args.bpe_path)
        if args.bpe_path
        else SimpleTokenizer(merges=[])
    )
    results: Dict[str, Dict] = {}
    cats = sorted(os.listdir(args.in_dir))
    for ci in shard_indices(len(cats), *rank_world(args.dist)):
        cat = cats[ci]
        prompt = f"a photo of a single {cat}"
        text_feat = enc.encode_texts(tok.tokenize([prompt]))
        files = sorted(glob(os.path.join(args.in_dir, cat, "*")))
        imgs, fracs, names = [], [], []
        for f in files:
            mask = os.path.join(
                args.mask_dir, cat, os.path.basename(f).rsplit(".", 1)[0] + ".png"
            )
            img, frac = load_masked_image(f, mask, background="white")
            imgs.append(img)
            fracs.append(frac)
            names.append(os.path.basename(f))
        if not imgs:
            continue
        feats = enc.encode_images(np.stack(imgs))
        scores = (feats @ text_feat.T)[:, 0]
        for n, s, fr in zip(names, scores, fracs):
            results[f"{cat}/{n}"] = {"clip_score": float(s), "mask_area": float(fr)}
    os.makedirs(args.out_dir, exist_ok=True)
    # per-rank partial + rank-0 merge
    rank, world = rank_world(args.dist)
    part = os.path.join(args.out_dir, f"results_rank{rank}.json")
    with open(part, "w") as f:
        json.dump(results, f)
    if rank == 0:
        merged = {}
        for r in range(world):
            pth = os.path.join(args.out_dir, f"results_rank{r}.json")
            if os.path.exists(pth):
                with open(pth) as f:
                    merged.update(json.load(f))
        with open(os.path.join(args.out_dir, "results.json"), "w") as f:
            json.dump(merged, f)
    print("clip_score done")
    return 0


# ---------------- 5. pool cleaner ----------------
def resize_nearest_cv2(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST)``: output
    pixel i reads input ``min(floor(i · n_in / n_out), n_in − 1)``."""
    rows = np.minimum(np.floor(np.arange(h) * (mask.shape[0] / h)).astype(np.int64),
                      mask.shape[0] - 1)
    cols = np.minimum(np.floor(np.arange(w) * (mask.shape[1] / w)).astype(np.int64),
                      mask.shape[1] - 1)
    return mask[rows[:, None], cols[None, :]]


def clean_pool(argv=None) -> int:
    p = argparse.ArgumentParser("clean_pool_if")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--mask_dirs", nargs="+", required=True, help="per seg-method mask dirs")
    p.add_argument("--score_jsons", nargs="+", required=True, help="per seg-method results.json")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--out_json", required=True)
    p.add_argument("--clip_threshold", type=float, default=0.2)
    p.add_argument("--area_min", type=float, default=0.05)
    p.add_argument("--area_max", type=float, default=0.95)
    p.add_argument("--similarity_csv", default="")
    p.add_argument("--name_to_id_json", default="", help="{category_name: cat_id}")
    p.add_argument("--workers", type=int, default=16)
    args = p.parse_args(argv)

    from concurrent.futures import ThreadPoolExecutor

    from ...utils.image_io import read_gray, read_rgb
    from ...utils.png import write_png

    scores = []
    for sj in args.score_jsons:
        with open(sj) as f:
            scores.append(json.load(f))
    keep_names = None
    if args.similarity_csv and os.path.exists(args.similarity_csv):
        keep_names = set()
        with open(args.similarity_csv) as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    keep_names.add(row[1])
    name2id = {}
    if args.name_to_id_json:
        with open(args.name_to_id_json) as f:
            name2id = json.load(f)

    def subwork(cat, fname):
        """The best method's mask → filters → the RGBA bbox crop."""
        key = f"{cat}/{fname}"
        best, best_score = -1, -1e9
        for mi, sc in enumerate(scores):
            if key in sc and sc[key]["clip_score"] > best_score:
                best, best_score = mi, sc[key]["clip_score"]
        if best < 0 or best_score < args.clip_threshold:
            return None
        if not args.area_min <= scores[best][key]["mask_area"] <= args.area_max:
            return None
        if keep_names is not None and fname not in keep_names:
            return None
        stem = fname.rsplit(".", 1)[0]
        img_path = os.path.join(args.image_dir, cat, fname)
        mask_path = os.path.join(args.mask_dirs[best], cat, stem + ".png")
        if not (os.path.exists(img_path) and os.path.exists(mask_path)):
            return None
        img, mask = read_rgb(img_path), read_gray(mask_path)
        if mask.shape[:2] != img.shape[:2]:
            mask = resize_nearest_cv2(mask, *img.shape[:2])
        ys, xs = np.where(mask > 127)
        if len(ys) == 0:
            return None
        rgba = np.dstack([img, mask])[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        out_cat = os.path.join(args.out_dir, cat)
        os.makedirs(out_cat, exist_ok=True)
        out_path = os.path.join(out_cat, stem + ".png")
        write_png(out_path, rgba)
        return cat, out_path

    jobs = [(cat, f) for cat in sorted(os.listdir(args.image_dir))
            for f in sorted(os.listdir(os.path.join(args.image_dir, cat)))]
    pool: Dict[str, List[str]] = defaultdict(list)
    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        for res in ex.map(lambda cf: subwork(*cf), jobs):
            if res:
                cat, path = res
                pool[str(name2id.get(cat, cat))].append(path)
    os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(pool, f)
    print(f"pool: {sum(len(v) for v in pool.values())} instances, {len(pool)} categories")
    return 0


# ---------------- 6. LVIS crop extraction ----------------
def lvis_crop(argv=None) -> int:
    """One PNG per annotation, ``<out_dir>/<category_id>/<annotation_id>.png``:
    the annotation's box cut tight, as a square, or padded by
    ``--padding_width``, over a white, black, box-blurred (``cv2.blur`` 10 x 10,
    ``native.box_blur``) or untouched background outside its polygons."""
    p = argparse.ArgumentParser("convert_lvis_to_coco_crop")
    p.add_argument("--lvis_json", required=True)
    p.add_argument("--image_root", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--crop_mode", choices=["tight", "square", "padding"], default="padding")
    p.add_argument("--background", choices=["white", "blur", "ori", "black"], default="blur")
    p.add_argument("--padding_width", type=int, default=40)
    p.add_argument("--max_per_category", type=int, default=0)
    args = p.parse_args(argv)

    from ... import native
    from ...utils.image_io import read_rgb
    from ...utils.mask_codec import polygons_to_bitmask
    from ...utils.png import write_png

    with open(args.lvis_json) as f:
        data = json.load(f)
    imgs = {i["id"]: i for i in data["images"]}
    per_cat_count: Dict[int, int] = defaultdict(int)
    for ann in data["annotations"]:
        cid = ann["category_id"]
        if args.max_per_category and per_cat_count[cid] >= args.max_per_category:
            continue
        info = imgs[ann["image_id"]]
        fn = info.get("file_name") or info["coco_url"][30:]
        try:
            img = read_rgb(os.path.join(args.image_root, fn))
        except FileNotFoundError:  # cv2.imread gives None: the JAX CLI skips it
            continue
        h, w = img.shape[:2]
        mask = polygons_to_bitmask(ann["segmentation"], h, w).astype(np.uint8)
        x, y, bw, bh = [int(round(v)) for v in ann["bbox"]]
        x2, y2 = min(x + bw, w), min(y + bh, h)
        x, y = max(x, 0), max(y, 0)
        if x2 - x < 2 or y2 - y < 2:
            continue
        if args.background == "white":
            img = np.where(mask[..., None] > 0, img, 255).astype(np.uint8)
        elif args.background == "black":
            img = np.where(mask[..., None] > 0, img, 0).astype(np.uint8)
        elif args.background == "blur":
            img = np.where(mask[..., None] > 0, img, native.box_blur(img, (10, 10)))
        if args.crop_mode == "tight":
            crop = img[y:y2, x:x2]
        elif args.crop_mode == "square":
            side = max(x2 - x, y2 - y)
            cx, cy = (x + x2) // 2, (y + y2) // 2
            xx, yy = max(cx - side // 2, 0), max(cy - side // 2, 0)
            crop = img[yy:min(yy + side, h), xx:min(xx + side, w)]
        else:  # padding
            pw = args.padding_width
            crop = img[max(y - pw, 0):min(y2 + pw, h), max(x - pw, 0):min(x2 + pw, w)]
        out_cat = os.path.join(args.out_dir, str(cid))
        os.makedirs(out_cat, exist_ok=True)
        write_png(os.path.join(out_cat, f"{ann['id']}.png"), np.ascontiguousarray(crop))
        per_cat_count[cid] += 1
    print("lvis_crop done")
    return 0
