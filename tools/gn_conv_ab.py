#!/usr/bin/env python3
"""A/B of the fused GroupNorm + SiLU + 3x3 conv kernel (kernel 8,
``fused_gn_silu_conv3x3``) against an earlier build, at every kernel-8 shape
of an SDXL UNet call, on one GPU.

Runs from the root of a checkout. Extract the earlier source first (the
machine that runs this needs no git), e.g. for the parent commit:

    mkdir -p build/scratch/old
    git show HEAD~1:divergen_tpu_torch/csrc/gn_conv.cu > build/scratch/old/gn_conv.cu
    python3 tools/gn_conv_ab.py build/scratch/old/gn_conv.cu

Builds that source and the checkout's ``csrc/gn_conv.cu`` with nvcc, each
into a library of its own under ``build/scratch/`` (headers from the source's
own directory first, then ``csrc/``), and calls their C entry points on the
same operands, scratch allocated once. An earlier build has either the
current interface (``dg_gn_conv_apply`` then ``dg_gn_conv_gemm``, with the
tile plan of ``ops/gn_conv.py:conv_plan``) or that of the mma.sync body the
wgmma one replaced (one ``dg_gn_conv``), so a variant of the current source
can be A/B'd as well.

For each shape of ``ops/gn_conv.py:UNET_CONVS`` (bf16 x and output, seeded
operands) it prints, for both builds, the relative L2 and max |error|
against the plain twin in float32 and whether two runs give the same bits;
then the device time of both in turns (earlier, current, current, earlier,
three times; each a ``chip_smoke.device_ms`` of 10 calls; medians of 6),
without the weight copy that the wrapper makes on each call, beside that of
``F.group_norm`` + ``F.silu`` + ``F.conv2d`` in bf16 on channels-last views,
and the bound (2 B H W 9 C Co FLOP at 989 TFLOP/s). Where the current build
has the apply pass, its device time alone too. Then the sums of median x
launches per UNet call. ``--timing-only`` times an earlier build that is not
meant to be right. Needs a CUDA device; prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ab_common import build, checked, in_turns
from chip_smoke import PEAK_BF16_FLOPS, card_line, device_ms
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import gn_conv as gc
from divergen_tpu_torch.ops.group_norm import moment_splits


def load(name: str, src: Path) -> ctypes.CDLL:
    lib = build("gn_conv_ab", name, src, report=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.split = hasattr(lib, "dg_gn_conv_gemm")
    if lib.split:
        lib.dg_gn_conv_apply.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
        lib.dg_gn_conv_gemm.argtypes = [p] * 4 + [i] * 8 + [p]
    else:
        lib.dg_gn_conv.argtypes = [p] * 9 + [i] * 8 + [f, i, p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", type=Path, help="the earlier build's gn_conv.cu")
    parser.add_argument("--timing-only", action="store_true",
                        help="time an earlier build that is not meant to be right: print its "
                             "errors, do not fail")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False  # the twin's f32 conv
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "gn_conv.cu")}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    totals = {"earlier": 0.0, "current": 0.0, "apply pass": 0.0, "PyTorch call": 0.0,
              "bound": 0.0}
    for (b, h, w, c, co), launches in gc.UNET_CONVS.items():
        x = (torch.randn((b, h, w, c), generator=g, device=dev) * 2.0 + 0.5).bfloat16()
        scale = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        shift = 0.1 * torch.randn(c, generator=g, device=dev)
        weight = (torch.randn((co, c, 3, 3), generator=g, device=dev) * (9 * c) ** -0.5).bfloat16()
        cbias = 0.1 * torch.randn(co, generator=g, device=dev)
        wt = gc.weight_operand(weight)
        cp = wt.shape[-1]
        groups = gc.group_count(c)
        splits = moment_splits(b, h * w, c)
        part = torch.empty((b, splits, 2, c), device=dev)
        fa, fs = torch.empty((b, c), device=dev), torch.empty((b, c), device=dev)
        y = torch.empty((b, h, w, cp), device=dev, dtype=torch.bfloat16)
        out = torch.empty((b, h, w, co), device=dev, dtype=torch.bfloat16)
        plan = gc.conv_plan(b, h, w, co, sms)

        def apply(lib):
            checked(lib.dg_gn_conv_apply(
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(), part.data_ptr(),
                fa.data_ptr(), fs.data_ptr(), y.data_ptr(), b, h, w, c, cp, groups, splits,
                1e-6, 0, stream))

        def call(lib):
            if not lib.split:
                return checked(lib.dg_gn_conv(
                    x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wt.data_ptr(),
                    cbias.data_ptr(), part.data_ptr(), fa.data_ptr(), fs.data_ptr(),
                    out.data_ptr(), b, h, w, c, cp, co, groups, splits, 1e-6, 0, stream))
            apply(lib)
            checked(lib.dg_gn_conv_gemm(
                y.data_ptr(), wt.data_ptr(), cbias.data_ptr(), out.data_ptr(), b, h, w, cp, co,
                plan.tw.bit_length() - 1, plan.blocks, 0, stream))

        ref = gc.fused_gn_silu_conv3x3_reference(x.float(), scale, shift, weight, cbias).float()
        what = f"(B, H, W, C, Co) = {(b, h, w, c, co)}"
        runs = {}
        for name, lib in libs.items():
            runs[name] = lambda lib=lib: call(lib)
            runs[name]()
            got = out.clone()
            runs[name]()
            same = torch.equal(got, out)
            diff = got.float() - ref
            rel = (diff.norm() / ref.norm()).item()
            err = diff.abs().max().item()
            print(f"{what} {name}: rel_l2 {rel:.4g}, max_abs_err {err:.4g} (max|ref| "
                  f"{ref.abs().max().item():.4g}), same bits twice: {same}", flush=True)
            wrong = (not torch.isfinite(got).all() or rel > 1e-2
                     or err > 3e-2 * ref.abs().max().item() or not same)
            if wrong and not (args.timing_only and name == "earlier"):
                raise AssertionError(f"{name} build is wrong at {what}")
        del ref
        nchw = x.permute(0, 3, 1, 2)  # channels-last memory
        w16 = weight.contiguous(memory_format=torch.channels_last)
        s16, b16, cb16 = scale.bfloat16(), shift.bfloat16(), cbias.bfloat16()
        library = device_ms(lambda: F.conv2d(F.silu(F.group_norm(nchw, groups, s16, b16, 1e-6)),
                                             w16, cb16, padding=1))
        dev_ms = in_turns(runs)
        apply_ms = device_ms(lambda: apply(libs["current"])) if libs["current"].split else 0.0
        flop = 2.0 * b * h * w * 9 * c * co
        bound = 1e3 * flop / PEAK_BF16_FLOPS
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}, {launches} launches per UNet call: device earlier "
              f"{dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), current "
              f"{dev_ms['current'][0]:.4f} ms (runs {text['current']}; apply pass "
              f"{apply_ms:.4f}), PyTorch call {library:.4f} ms, bound {bound:.4f} ms "
              f"({flop / 1e9:.1f} GFLOP; current at {flop / dev_ms['current'][0] / 1e9:.0f} "
              f"TFLOP/s); tiles {plan.th} x {plan.tw} by {gc.CONV_BN}, "
              f"{plan.tiles_m * plan.tiles_n} on {plan.blocks} blocks", flush=True)
        for name, ms in (("earlier", dev_ms["earlier"][0]), ("current", dev_ms["current"][0]),
                         ("apply pass", apply_ms), ("PyTorch call", library), ("bound", bound)):
            totals[name] += ms * launches
        del x, weight, wt, part, y, out, nchw, w16
        torch.cuda.empty_cache()
    print("per UNet call (median x launches, ms): "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
