#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's instance chain and detector on one GPU.

Runs from the root of a checkout:
    python3 tools/profile_torch_chain.py [sam] [clip] [paste] [detector]
(no argument: all four targets).

Builds SAM ViT-H (bf16, fused encoder), the CLIP ViT-L/14 vision tower
(float32), the compositor's benchmark batch, and the flagship detector
(``graft_entry.flagship_entry``: Swin-L + FPN + CenterNet2 + Detic cascade +
mask head, B = 2, 896², bf16) with random weights from fixed seeds, warms each
up twice, then traces 3 back-to-back calls of each with ``torch.profiler``
(CPU + CUDA activities). For each stage it prints the wall time per call, the
summed device time and the number of its kernel launches, the idle share
(1 − device time / wall)
and the kernels that take most of the device time; for the detector also its
three parts on their own and the host syncs of NMS per forward.
Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CALLS = 3
TOP = 12


def trace(name: str, fn) -> None:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / CALLS
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / CALLS, e.count // CALLS)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key != "Command Buffer Full"]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    print(f"{name}: wall {wall_ms:.3f} ms/call, device kernels {device_ms:.3f} ms/call "
          f"in {sum(r[2] for r in rows)} launches, "
          f"idle share {max(0.0, 1 - device_ms / wall_ms):.3f}", flush=True)
    for key, ms, count in rows[:TOP]:
        print(f"    {ms:9.3f} ms  x{count:<4d} {key[:110]}")


TARGETS = ("sam", "clip", "paste", "detector")


def profile_sam(dev, g) -> None:
    from divergen_tpu_torch.pipeline.segmentation import corner_masks

    args = corner_masks.build_argparser().parse_args(["--in_dir", "-", "--out_dir", "-"])
    sam = corner_masks.build_sam(args, dev)
    imgs = torch.rand((args.batch, 1024, 1024, 3), generator=g, device=dev) * 255
    pts = torch.from_numpy(np.tile(corner_masks.corner_points(1024, 10),
                                   (args.batch, 1, 1))).to(dev)
    lbl = torch.ones((args.batch, 4), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        trace(f"SAM ViT-H forward, B={args.batch}, 1024², bf16, fused encoder",
              lambda: sam(imgs, pts, lbl))
        trace(f"SAM ViT-H encoder only, B={args.batch}",
              lambda: sam.encoder((imgs - sam.pixel_mean) / sam.pixel_std))


def profile_clip(dev, g) -> None:
    from divergen_tpu_torch.modeling.text.clip import preprocess_images
    from divergen_tpu_torch.pipeline.filteration.core import ClipEncoder

    clip = ClipEncoder("ViT-L/14", batch=16, device=dev)
    x = preprocess_images(torch.rand((16, 224, 224, 3), generator=g, device=dev) * 255)
    with torch.inference_mode():
        trace("CLIP ViT-L/14 vision, B=16, 224², float32", lambda: clip.vision(x))


def profile_paste(dev, g) -> None:
    from divergen_tpu_torch.ops.copy_paste import paste_instances_boxframe

    b, p, n, s, ps, hw = 8, 4, 8, 28, 128, 896
    paste_args = (
        torch.rand((b, hw, hw, 3), generator=g, device=dev) * 255,
        torch.ones((b, n, s, s), device=dev),
        torch.tensor([100.0, 100.0, 300.0, 300.0], device=dev).expand(b, n, 4),
        torch.zeros((b, n), dtype=torch.int32, device=dev),
        torch.ones((b, n), dtype=torch.bool, device=dev),
        torch.zeros((b, n), dtype=torch.int32, device=dev),
        torch.rand((b, p, ps, ps, 4), generator=g, device=dev),
        torch.tensor([200.0, 200.0, 400.0, 400.0], device=dev).expand(b, p, 4),
        torch.zeros((b, p), dtype=torch.int32, device=dev),
        torch.ones((b, p), dtype=torch.bool, device=dev),
        torch.zeros((b, p), dtype=torch.bool, device=dev),
    )
    trace(f"paste_instances_boxframe, B={b} P={p} N={n} S={s}, {hw}²",
          lambda: paste_instances_boxframe(*paste_args))


def profile_detector(dev, g) -> None:
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.ops.nms import nms_mask
    from divergen_tpu_torch.ops.window_attention import fused_window_attention_packed

    model, (images, sizes) = graft_entry.flagship_entry(device=dev)
    what = f"B={images.shape[0]}, {images.shape[1]}², bf16"
    with torch.no_grad():
        feats = model.backbone_features(images)
        props = model.proposals(feats, sizes)
        launches, syncs = fused_window_attention_packed.launches, nms_mask.host_syncs
        dets = model(images, sizes)
        print(f"detector forward: {fused_window_attention_packed.launches - launches} "
              f"fused_window_attention_packed launches, {nms_mask.host_syncs - syncs} host syncs "
              f"in NMS, detections {[int(n) for n in dets['valid'].sum(dim=1)]}", flush=True)
        trace(f"detector forward (Swin-L + FPN + CenterNet2 + cascade + mask), {what}",
              lambda: model(images, sizes))
        trace(f"detector backbone + FPN, {what}", lambda: model.backbone_features(images))
        trace(f"detector proposals + NMS, {what}", lambda: model.proposals(feats, sizes))
        trace(f"detector ROI heads (3 cascade stages, NMS, mask head), {what}",
              lambda: model.roi_heads.inference(feats, props, sizes))


def main(argv=None) -> int:
    targets = list(sys.argv[1:] if argv is None else argv) or list(TARGETS)
    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        print(f"profile_torch_chain: unknown targets {unknown}; choose from {TARGETS}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_torch_chain: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    run = {"sam": profile_sam, "clip": profile_clip, "paste": profile_paste,
           "detector": profile_detector}
    for target in targets:
        run[target](dev, g)
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
