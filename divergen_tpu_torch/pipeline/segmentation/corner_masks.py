"""SAM corner-prompt instance annotation CLI (torch).

Counterpart of ``divergen_tpu/pipeline/segmentation/corner_masks.py``, with
the same flags plus ``--device``: 4 image-corner points with
``--corner_margin`` prompted as foreground of the background, mask slot 2
taken and inverted → instance mask PNG 0/255; categories sorted by
image_count; files rank-sharded ``i % world == rank``; existence-check
resume. Files go through the model in fixed-size batches; the resizes (to the
model's square input, bilinear, and of the mask back to the image's size,
nearest) run on the device. Without ``--sam_checkpoint`` the model runs on
random weights drawn from a fixed seed. Inputs are PNG or baseline JPEG
(``utils/image_io.py``, the pixels of ``cv2.imread``).

    python -m divergen_tpu_torch.pipeline.segmentation.corner_masks \\
        --in_dir samples/ --out_dir masks/ --model_type vit_h --batch 4
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np
import torch
import torch.nn.functional as F


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("get_background_sam_mask")
    p.add_argument("--sam_checkpoint", type=str, default="")
    p.add_argument("--model_type", type=str, default="vit_h")
    p.add_argument("--in_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--dataset_json_path", type=str, default="")
    p.add_argument("--corner_margin", type=int, default=10)
    p.add_argument("--img_size", type=int, default=1024)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--dist", action="store_true", default=False,
                   help="rank and world size from an initialized torch.distributed")
    p.add_argument("--disable_overwrite", action="store_true", default=True)
    p.add_argument("--tiny", action="store_true", help="tiny random model (smoke)")
    # the default encoder folds the block LayerNorms into their GEMMs and runs
    # the global layers through the relative-position flash kernel;
    # --no_fused_encoder selects the plain path
    p.add_argument("--no_fused_encoder", action="store_true", default=False)
    p.add_argument("--device", type=str, default="",
                   help="torch device (default: cuda; without a card pass cpu, nothing falls back)")
    return p


def corner_points(size: int, margin: int) -> np.ndarray:
    """(4, 2) xy prompts at the 4 corners."""
    m = margin
    return np.array(
        [[m, m], [size - m, m], [m, size - m], [size - m, size - m]], np.float32
    )


def build_sam(args, device=None):
    """The SAM module for ``args``, in eval mode, with the checkpoint's
    weights or random ones from seed 0."""
    from ...modeling.layers import flax_init_
    from ...utils.dist import entry_device
    from .sam import SAM

    device = entry_device(device or args.device)
    fused = not getattr(args, "no_fused_encoder", False)
    if args.tiny:
        sam = SAM.tiny(img_size=args.img_size, device=device)
    elif args.model_type == "vit_b":
        sam = SAM.vit_b(dtype=torch.bfloat16, device=device)
    else:
        sam = SAM.vit_h(dtype=torch.bfloat16, ln_gemm=fused, flash_attn=fused, device=device)
    if args.sam_checkpoint:
        from ...utils.convert import params_from_jax
        from ...utils.torch_weights import load_sam_params

        sam.load_state_dict(params_from_jax(load_sam_params(args.sam_checkpoint, sam), sam))
    else:
        flax_init_(sam, torch.Generator(device=device).manual_seed(0))
    return sam.eval()


@torch.inference_mode()
def predict_instance_masks(sam, images: torch.Tensor, points: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """images (B, S, S, 3) RGB 0..255 → (B, S, S) bool instance masks: mask
    slot 2 is the whole-background mask, the instance is its inverse."""
    from .sam import upscale_masks

    masks, _ = sam(images, points, labels)
    return upscale_masks(masks.float(), images.shape[1])[:, 2] <= 0.0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ...utils.dist import entry_device, rank_world
    from ...utils.image_io import read_rgb
    from ...utils.png import write_png

    device = entry_device(args.device)
    rank, world = rank_world(args.dist)

    # categories sorted by image_count ascending
    cats = sorted(os.listdir(args.in_dir))
    if args.dataset_json_path and os.path.exists(args.dataset_json_path):
        with open(args.dataset_json_path) as f:
            infos = {c["name"]: c.get("image_count", 0) for c in json.load(f)["categories"]}
        cats.sort(key=lambda c: infos.get(c, 0))

    sam = build_sam(args, device)
    size = args.img_size
    pts = torch.from_numpy(np.tile(corner_points(size, args.corner_margin),
                                   (args.batch, 1, 1))).to(device)
    lbl = torch.ones((args.batch, 4), dtype=torch.int32, device=device)

    n_done = 0
    for cat in cats:
        files = sorted(glob(os.path.join(args.in_dir, cat, "*.png")) +
                       glob(os.path.join(args.in_dir, cat, "*.jpg")))
        files = [f for i, f in enumerate(files) if i % world == rank]
        out_cat = os.path.join(args.out_dir, cat)
        os.makedirs(out_cat, exist_ok=True)
        todo = []
        for f in files:
            out_path = os.path.join(out_cat, os.path.basename(f).rsplit(".", 1)[0] + ".png")
            if args.disable_overwrite and os.path.exists(out_path):
                continue
            todo.append((f, out_path))
        for ofs in range(0, len(todo), args.batch):
            chunk = todo[ofs: ofs + args.batch]
            imgs = torch.zeros((args.batch, size, size, 3), device=device)
            shapes = []
            for k, (f, _) in enumerate(chunk):
                img = torch.from_numpy(read_rgb(f)).to(device)
                shapes.append(tuple(img.shape[:2]))
                # cv2.resize's default: bilinear, half-pixel centers, no antialias
                chw = img.permute(2, 0, 1)[None].float()
                imgs[k] = F.interpolate(chw, size=(size, size), mode="bilinear",
                                        align_corners=False)[0].permute(1, 2, 0)
            inst = predict_instance_masks(sam, imgs, pts, lbl)
            for k, (f, out_path) in enumerate(chunk):
                m = (inst[k].to(torch.uint8) * 255)[None, None]
                m = F.interpolate(m, size=shapes[k], mode="nearest")[0, 0]
                write_png(out_path, m.cpu().numpy())
                n_done += 1
    print(f"done: {n_done} masks → {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
