#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's instance chain on one GPU.

Runs from the root of a checkout:  python3 tools/profile_torch_chain.py

Builds SAM ViT-H (bf16, fused encoder), the CLIP ViT-L/14 vision tower
(float32) and the compositor's benchmark batch with random weights from fixed
seeds, warms each up twice, then traces 3 back-to-back calls of each with
``torch.profiler`` (CPU + CUDA activities). For each stage it prints the wall
time per call, the summed device time of its kernels, the idle share
(1 − device time / wall) and the kernels that take most of the device time.
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
    print(f"{name}: wall {wall_ms:.3f} ms/call, device kernels {device_ms:.3f} ms/call, "
          f"idle share {max(0.0, 1 - device_ms / wall_ms):.3f}", flush=True)
    for key, ms, count in rows[:TOP]:
        print(f"    {ms:9.3f} ms  x{count:<4d} {key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_chain: no CUDA device", file=sys.stderr)
        return 1
    from divergen_tpu_torch.modeling.text.clip import preprocess_images
    from divergen_tpu_torch.ops.copy_paste import paste_instances_boxframe
    from divergen_tpu_torch.pipeline.filteration.core import ClipEncoder
    from divergen_tpu_torch.pipeline.segmentation import corner_masks

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

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
    del sam
    torch.cuda.empty_cache()

    clip = ClipEncoder("ViT-L/14", batch=16, device=dev)
    x = preprocess_images(torch.rand((16, 224, 224, 3), generator=g, device=dev) * 255)
    with torch.inference_mode():
        trace("CLIP ViT-L/14 vision, B=16, 224², float32", lambda: clip.vision(x))
    del clip
    torch.cuda.empty_cache()

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
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
