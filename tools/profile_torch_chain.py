#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's instance chain and detector on one GPU.

Runs from the root of a checkout:
    python3 tools/profile_torch_chain.py [sdxl] [sam] [clip] [paste] [detector] [train]
(no argument: all six targets).

The ``sdxl`` target traces one CFG UNet call of SDXL-base at B = 2 (UNet
batch 4), 1024², seeded weights, in bf16, in the int8 + fused-norm serving
configuration (``UNetSDXL(quant, fused_ln, fused_gn)`` on the same weights,
after ``quantize_unet_``, which it also traces alone) and with fused
ResBlocks (``UNetSDXL(conv_matmul="fused")``), and prints the kernel launches
of one call of each. Then the 17 ResBlocks alone on the inputs they get in
that call, bf16 (cuDNN convs and the plain GroupNorm) and fused (kernel 8),
and kernel 8's per-call weight copies alone.

Builds SAM ViT-H (bf16, fused encoder), the CLIP ViT-L/14 vision tower
(float32), the compositor's benchmark batch, and the flagship detector
(``graft_entry.flagship_entry``: Swin-L + FPN + CenterNet2 + Detic cascade +
mask head, B = 2, 896², bf16) with random weights from fixed seeds, warms each
up twice, then traces 3 back-to-back calls of each with ``torch.profiler``
(CPU + CUDA activities). For each stage it prints the wall time per call, the
summed device time and the number of its kernel launches, the idle share
(1 − device time / wall)
and the kernels that take most of the device time; for the detector also its
three parts on their own and the host syncs of NMS per forward. The ``train``
target builds ``graft_entry.flagship_train_entry`` (the same detector with
float32 parameters, AdamW, EMA, the compositor) and traces the whole step with
and without rematerialization, then, with it, the compositor, the forward with
its losses, forward + backward, and the optimizer with the EMA on their own;
the backward's share is the difference of the middle two.
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


def trace(name: str, fn, also=()) -> None:
    """Prints the wall and device time of ``fn`` and its largest device items,
    and beyond those the items whose name holds one of the strings ``also``."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / CALLS
    # device-side events only: an operator's row repeats its kernels' time, and so
    # does the device-side annotation that torch.optim puts around its step
    rows = [(e.key, e.self_device_time_total / 1e3 / CALLS, e.count // CALLS)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key != "Command Buffer Full" and not e.key.startswith("Optimizer.step#")]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    print(f"{name}: wall {wall_ms:.3f} ms/call, device kernels {device_ms:.3f} ms/call "
          f"in {sum(r[2] for r in rows)} launches, "
          f"idle share {max(0.0, 1 - device_ms / wall_ms):.3f}", flush=True)
    for i, (key, ms, count) in enumerate(rows):
        if i < TOP or any(a in key for a in also):
            print(f"    {ms:9.3f} ms  x{count:<4d} {key[:110]}")


TARGETS = ("sdxl", "sam", "clip", "paste", "detector", "train")


def profile_sdxl(dev, g) -> None:
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.ops import flash_attention, gn_conv, group_norm, int8_matmul
    from divergen_tpu_torch.ops import layer_norm, ln_matmul
    from divergen_tpu_torch.pipeline.generation.unet import ResBlock, UNetSDXL, quantize_unet_

    wrappers = (flash_attention.flash_attention_packed, ln_matmul.fused_ln_matmul,
                int8_matmul.int8_matmul_fused_quant, int8_matmul.int8_matmul_pallas,
                layer_norm.fused_layer_norm, group_norm.fused_group_norm,
                gn_conv.fused_gn_silu_conv3x3)
    bf16 = torch.bfloat16
    unet = flax_init_(UNetSDXL(dtype=bf16, device=dev), torch.Generator(device=dev).manual_seed(0))
    unet8 = UNetSDXL(dtype=bf16, device=dev, quant=True, fused_ln=True, fused_gn=True)
    unet8.load_state_dict(unet.state_dict())
    quantize_unet_(unet8)
    unet_f = UNetSDXL(dtype=bf16, device=dev, conv_matmul="fused")
    unet_f.load_state_dict(unet.state_dict())
    args = (torch.randn((4, 128, 128, 4), generator=g, device=dev),
            torch.full((4,), 500.0, device=dev),
            torch.randn((4, 77, 2048), generator=g, device=dev),
            torch.randn((4, 1280), generator=g, device=dev),
            torch.tensor([1024.0, 1024, 0, 0, 1024, 1024], device=dev).expand(4, 6))
    what = "B=2 images (UNet batch 4), 1024²"
    with torch.inference_mode():
        for name, model in (("bf16", unet), ("int8 + fused norms", unet8),
                            ('conv_matmul="fused"', unet_f)):
            before = [w.launches for w in wrappers]
            model(*args)
            counts = {w.__name__: w.launches - b for w, b in zip(wrappers, before)}
            print(f"UNet call ({name}): kernel launches {counts}", flush=True)
            trace(f"UNet call, {name}, {what}", lambda: model(*args),
                  also=("attn_sm90", "int8_gemm", "quantize_rows", "gn_moments", "gn_finalize",
                        "gn_apply", "ln_vec", "ln_any", "conv_gemm", "gnc_fold", "gnc_apply"))
        trace("quantize_unet_ (the transformer weights of SDXL-base, once per denoise call)",
              lambda: quantize_unet_(unet8))

        # the ResBlocks alone, on the inputs one UNet call gives them
        inputs = {}

        def keep(block, block_args):
            inputs.setdefault(block, block_args)  # returns None: the call goes on unchanged

        hooks = [m.register_forward_pre_hook(keep) for m in unet.modules()
                 if isinstance(m, ResBlock)]
        unet(*args)
        for h in hooks:
            h.remove()
        pairs = [(dict(unet.named_modules())[n], unet_f.get_submodule(n))
                 for n, m in unet.named_modules() if m in inputs]
        trace(f"the {len(pairs)} ResBlocks alone, bf16 (cuDNN convs, plain GroupNorm32 + SiLU)",
              lambda: [rb(*inputs[rb]) for rb, _ in pairs])
        trace(f"the {len(pairs)} ResBlocks alone, fused (fused_gn_silu_conv3x3)",
              lambda: [rf(*inputs[rb]) for rb, rf in pairs],
              also=("conv_gemm", "gnc_fold", "gnc_apply", "gn_moments"))
        weights = [c.weight for _, rf in pairs for c in (rf.conv1, rf.conv2)]
        trace(f"kernel 8's weight copies alone ({len(weights)} per UNet call)",
              lambda: [gn_conv.weight_operand(w) for w in weights])


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


def profile_train(dev, g) -> None:
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.engine.trainer import composite
    from divergen_tpu_torch.ops.nms import nms_mask
    from divergen_tpu_torch.ops.window_attention import fused_window_attention_packed as packed
    from divergen_tpu_torch.solver.build import ema_update

    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, (state, batch, rng) = graft_entry.flagship_train_entry(device=dev, remat=remat)
        model, optimizer = state.model, state.optimizer
        b, size = batch["image"].shape[:2]
        what = f"B={b}, {size}², bf16 over f32 parameters, remat {remat}"
        fwd, bwd, syncs = packed.launches, packed.backward_launches, nms_mask.host_syncs
        state, metrics = step(state, batch, rng)
        print(f"train step ({what}): {packed.launches - fwd} forward and "
              f"{packed.backward_launches - bwd} backward fused_window_attention_packed launches, "
              f"{nms_mask.host_syncs - syncs} host syncs in NMS, total_loss "
              f"{float(metrics['total_loss']):.4f}", flush=True)
        trace(f"train step, compositor on ({what})", lambda: step(state, batch, rng),
              also=("window_attn", "dbias_reduce"))
        print(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if not remat:
            del step, state, batch, rng, model, optimizer, metrics
            continue
        images, gt = composite(batch, "basic")

        def forward():
            return model(images, batch["image_size"], gt=gt, rng=rng,
                         fed_weight=batch["fed_weight"], training=True)

        def forward_backward():
            optimizer.zero_grad()
            sum(forward().values()).backward()

        def update():
            optimizer.step()
            ema_update(state.ema_params, state.params, 0.999)

        trace(f"compositor ({what})", lambda: composite(batch, "basic"))
        trace(f"forward with losses ({what})", forward)
        trace(f"forward + backward ({what})", forward_backward)
        trace(f"clip + AdamW + EMA ({what})", update)


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
    run = {"sdxl": profile_sdxl, "sam": profile_sam, "clip": profile_clip, "paste": profile_paste,
           "detector": profile_detector, "train": profile_train}
    for target in targets:
        run[target](dev, g)
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
