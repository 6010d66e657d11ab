#!/usr/bin/env python3
"""Float32 end to end on one GPU: ``graft_entry.entry()``'s forward (the
Swin-T detector at 128², float32 as the JAX ``entry()``: 12 launches of the
float32 window forward) and a float32 SAM ViT-H image-encoder forward at
B = 1, 1024², with ``ln_gemm`` and flash attention on (36 kernel-2 and 4
kernel-4 launches in float32), each with its wall time (host clock around a
synchronised call) and device time (``chip_smoke.device_ms``), and its
launches of the float32 bodies.

Runs the port of the checkout at ``--root`` (default: this one), so that an
earlier checkout unpacked beside this one is timed by the same script:

    git archive HEAD~1 | tar -x -C build/scratch/parent
    for r in build/scratch/parent . . build/scratch/parent; do
        python3 tools/f32_e2e.py --root $r; done

Weights are random from fixed seeds (``graft_entry.fast_init_``). Needs a
CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def wall_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE, help="the checkout whose port runs")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from chip_smoke import card_line, device_ms  # this checkout's timing helpers
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.ops import flash_attention as fa
    from divergen_tpu_torch.ops import ln_matmul as lm
    from divergen_tpu_torch.ops import window_attention as wa
    from divergen_tpu_torch.pipeline.segmentation.sam import SAMImageEncoder

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import divergen_tpu_torch

    print(f"port: {Path(divergen_tpu_torch.__file__).parent}; device: "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counted = (("window forward", wa.fused_window_attention_packed),
               ("kernel 2", lm.fused_ln_matmul), ("kernel 4", fa.flash_attention_relpos))

    def launches(fn):
        for _, w in counted:
            w.launches = 0
        fn()
        torch.cuda.synchronize()
        return ", ".join(f"{name} {w.launches}" for name, w in counted)

    with torch.no_grad():
        model, (images, sizes) = graft_entry.entry()
        run = lambda: model(images, sizes)
        ran = launches(run)
        print(f"entry() forward (Swin-T, 128², float32): wall {wall_ms(run, 20):.3f} ms, device "
              f"{device_ms(run, reps=10):.3f} ms; launches a call: {ran}", flush=True)
        del model

        enc = SAMImageEncoder(dtype=torch.float32, ln_gemm=True, flash_attn=True,
                              device="cuda").eval()
        graft_entry.fast_init_(enc, torch.Generator().manual_seed(0))
        x = torch.randn((1, 1024, 1024, 3), generator=torch.Generator().manual_seed(1)).cuda()
        run = lambda: enc(x)
        ran = launches(run)
        print(f"SAM ViT-H image encoder forward (B = 1, 1024², float32, ln_gemm and flash "
              f"attention): wall {wall_ms(run, 5):.3f} ms, device {device_ms(run, reps=3):.3f} "
              f"ms; launches a call: {ran}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
