"""SDXL's CFG denoise with and without Faster-Diffusion encoder reuse, on one
GPU, in alternating pairs.

    python3 tools/encoder_reuse_ab.py [--pairs 10] [--steps 4] [--size 1024]

The full-width SDXL-base UNet in bf16 on seeded random weights, B = 2 images
(UNet batch 4: CFG), DPM-Solver++ 2M, random conditioning. It times whole
``SDXLPipeline.denoise`` runs on the host's clock between synchronizations,
exact and reuse in turns (the first of each pair alternating), and prints
each side's median ms a step with its quartiles, the pairs reuse wins, and
the device time of one full UNet call (which also returns its down path's
features) and of one reuse call (mid + up on them), with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, device_ms, log, wall_s  # noqa: E402
from divergen_tpu_torch.modeling.layers import flax_init_  # noqa: E402
from divergen_tpu_torch.ops import _build  # noqa: E402
from divergen_tpu_torch.pipeline.generation.pipeline import SDXLPipeline  # noqa: E402
from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL  # noqa: E402


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser("encoder_reuse_ab")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--size", type=int, default=1024)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("encoder_reuse_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    _build.build()
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    unet = flax_init_(UNetSDXL(dtype=torch.bfloat16, device=dev), gen.manual_seed(0))
    pipes = {reuse: SDXLPipeline(unet, None, steps=args.steps, sampler="dpmpp_2m",
                                 encoder_reuse=reuse) for reuse in (False, True)}
    b, h = 2, args.size // 8
    ctx, unc = (torch.randn((b, 77, 2048), generator=gen, device=dev) for _ in range(2))
    pooled = torch.zeros((b, 1280), device=dev)
    time_ids = torch.tensor([args.size, args.size, 0, 0, args.size, args.size],
                            dtype=torch.float32, device=dev).expand(b, 6)
    lat0 = torch.randn((b, h, h, 4), generator=gen, device=dev) * pipes[False]._init_scale

    def run(reuse):
        return wall_s(lambda: pipes[reuse].denoise(lat0, ctx, unc, pooled, pooled, time_ids))

    for reuse in (False, True):
        run(reuse)  # warm-up
    times = {False: [], True: []}
    wins = 0
    for i in range(args.pairs):
        order = (False, True) if i % 2 == 0 else (True, False)
        pair = {reuse: run(reuse) for reuse in order}
        for reuse, t in pair.items():
            times[reuse].append(1e3 * t / args.steps)
        wins += pair[True] < pair[False]
    for reuse, name in ((False, "exact"), (True, "encoder reuse")):
        lo, hi = quartiles(times[reuse])
        log(f"{name}: {statistics.median(times[reuse]):.1f} ms a CFG step (quartiles {lo:.1f}, "
            f"{hi:.1f}; runs {[round(t, 1) for t in times[reuse]]}) [{card}]")
    log(f"encoder reuse faster in {wins} of {args.pairs} pairs "
        f"(B = {b}, {args.size}², {args.steps} steps a run)")

    x2 = torch.randn((2 * b, h, h, 4), generator=gen, device=dev)
    t2 = torch.full((2 * b,), 500.0, device=dev)
    ctx2 = torch.cat([unc, ctx])
    pooled2, ids2 = torch.zeros((2 * b, 1280), device=dev), torch.cat([time_ids, time_ids])
    with torch.inference_mode():
        _, cache = unet(x2, t2, ctx2, pooled2, ids2, return_encoder=True)
        full = device_ms(lambda: unet(x2, t2, ctx2, pooled2, ids2, return_encoder=True))
        reused = device_ms(lambda: unet(x2, t2, ctx2, pooled2, ids2, cached_encoder=cache))
    log(f"device time a UNet call (batch {2 * b}): full {full:.3f} ms, reuse {reused:.3f} ms "
        f"({reused / full:.3f} of full) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
