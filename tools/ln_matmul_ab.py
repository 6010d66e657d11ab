#!/usr/bin/env python3
"""A/B of the fused LayerNorm + GEMM kernel (kernel 2, ``fused_ln_matmul``)
against an earlier build, at the shapes the main path launches, on one GPU.

Runs from the root of a checkout. Extract the earlier source first (the
machine that runs this needs no git), e.g. for the parent commit:

    mkdir -p build/scratch/old
    git show HEAD~1:divergen_tpu_torch/csrc/ln_matmul.cu > build/scratch/old/ln_matmul.cu
    python3 tools/ln_matmul_ab.py build/scratch/old/ln_matmul.cu

Builds that source and the checkout's ``csrc/ln_matmul.cu`` with nvcc, each
into a library of its own under ``build/scratch/`` (headers from the source's
own directory first, then ``csrc/``), and calls their C entry points on the
same bf16 operands, scratch allocated once. An earlier build has either the
current interface (``dg_ln_apply`` then ``dg_ln_gemm``, with the blocks of
``ops/ln_matmul.py:gemm_plan``) or that of the mma.sync body the wgmma one
replaced (one ``dg_ln_matmul_bf16``: a stats pass, then a GEMM normalizing
its own tiles), so a variant of the current source can be A/B'd as well.

Shapes: the UNet's two GEGLU shapes of an SDXL call at 1024² (UNet batch 4:
10 launches at (16384, 640, 5120), 60 at (4096, 1280, 10240)) and SAM ViT-H's
qkv (none, with bias) and mlp_fc1 (GELU, with bias) at B = 4. For each it
prints, for both builds, the relative L2 and max |error| against the plain
twin in float32 and whether two runs give the same bits; then the device time
of both in turns (earlier, current, current, earlier, three times; each a
``chip_smoke.device_ms`` of 10 calls; medians of 6), beside that of the
PyTorch call computing the same function in bf16 (``F.layer_norm`` +
``F.linear`` + GEGLU or GELU), the current build's apply pass alone and the
bound (2 M K N FLOP at 989 TFLOP/s). Then the sums of median x launches over
a UNet call's 70 launches. ``--timing-only`` times an earlier build that is
not meant to be right. ``--groups 1,4,16`` also times the current build with
each of these row-tile groups in its tile order (``GemmPlan.group``; the
plan's own is ``ln_matmul.GEMM_GROUP``), in rounds. ``--f32`` times the
float32 GEMM instead (``dg_ln_gemm_f32``) at the same four shapes on float32
x and weight: the earlier build's (e.g. the parent's FMA body: the apply pass
in float32, then the GEMM) against the current one's (the apply pass writing
y's two TF32 parts, ``dg_tf32_split`` of the weight, the 3xTF32 GEMM), each
held to ``chip_smoke.F32_BOUNDS`` against the twin, beside the PyTorch
float32 call (TF32 off) with the names of its longest kernels, the current
build's apply pass and weight split alone, and the bounds at 3xTF32 and at
FMA. Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ab_common import build, checked, in_turns
from chip_smoke import (F32_BOUNDS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_F32_FLOPS,
                        PEAK_F32_TC_FLOPS, card_line, compare, device_kernels, device_ms)
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import ln_matmul as lm

# (M, K, N, epilogue, bias, eps) -> launches per UNet call (0: SAM's shapes)
SHAPES = {(16384, 640, 5120, "geglu", False, 1e-5): 10,
          (4096, 1280, 10240, "geglu", False, 1e-5): 60,
          (16384, 1280, 3840, "none", True, 1e-6): 0,
          (16384, 1280, 5120, "gelu", True, 1e-6): 0}
EPILOGUE = {"none": 0, "gelu": 1, "geglu": 2}


def load(name: str, src: Path) -> ctypes.CDLL:
    lib = build("ln_matmul_ab", name, src, report=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tf32x3 = hasattr(lib, "dg_tf32_split")
    if lib.tf32x3:
        lib.dg_tf32_split.argtypes = [p, p, ctypes.c_int64, p]
        lib.dg_ln_gemm_f32.argtypes = [p] * 4 + [i] * 6 + [p]
    elif hasattr(lib, "dg_ln_gemm_f32"):
        lib.dg_ln_gemm_f32.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.split = hasattr(lib, "dg_ln_gemm")
    if lib.split:
        lib.dg_ln_apply.argtypes = [p] * 4 + [i] * 2 + [f, i, p]
        lib.dg_ln_gemm.argtypes = [p] * 4 + [i] * 6 + [p]
    else:
        lib.dg_ln_matmul_bf16.argtypes = [p] * 7 + [i] * 3 + [f, i, p]
    return lib


def main_f32(libs: dict, dev: torch.device, g: torch.Generator, stream: int, sms: int) -> int:
    for (m, k, n, epi, with_bias, eps), launches in SHAPES.items():
        geglu = epi == "geglu"
        act = "gelu" if epi == "gelu" else "none"
        x = torch.randn((m, k), generator=g, device=dev) * 2.0 + 0.5
        wt = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
        beta = 0.1 * torch.randn(k, generator=g, device=dev)
        bias = 0.1 * torch.randn(n, generator=g, device=dev) if with_bias else None
        bias_ptr = None if bias is None else bias.data_ptr()
        cols = n // 2 if geglu else n
        y = torch.empty((2, m, k), device=dev)
        w2 = torch.empty((2, n, k), device=dev)
        out = torch.empty((m, cols), device=dev)
        plan = lm.gemm_plan(m, n, geglu, sms)

        def apply(lib):
            checked(lib.dg_ln_apply(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                    y.data_ptr(), m, k, eps, 1, stream))

        def split(lib):
            checked(lib.dg_tf32_split(wt.data_ptr(), w2.data_ptr(), n * k, stream))

        def call(lib):
            apply(lib)
            if lib.tf32x3:
                split(lib)
                checked(lib.dg_ln_gemm_f32(y.data_ptr(), w2.data_ptr(), bias_ptr, out.data_ptr(),
                                           m, n, k, EPILOGUE[epi], plan.blocks, plan.group,
                                           stream))
            else:
                checked(lib.dg_ln_gemm_f32(y.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(),
                                           m, n, k, EPILOGUE[epi], stream))

        plain = lambda: lm.ln_matmul_reference(x, wt.t(), gamma, beta, eps, bias, geglu, act)
        ref = plain()
        what = f"float32 (M, K, N) = {(m, k, n)} {epi}{' + bias' if with_bias else ''}"
        runs = {}
        for name, lib in libs.items():
            runs[name] = lambda lib=lib: call(lib)
            runs[name]()
            got = out.clone()
            runs[name]()
            same = torch.equal(got, out)
            compare(f"{what} {name}", got, ref, **F32_BOUNDS)
            print(f"    same bits twice: {same}", flush=True)
            if not same:
                raise AssertionError(f"{name} build gives other bits at {what}")
        del ref

        def library():
            h = F.linear(F.layer_norm(x, (k,), gamma, beta, eps), wt, bias)
            if geglu:
                hidden, gate = h.chunk(2, dim=-1)
                return hidden * F.gelu(gate)
            return F.gelu(h) if epi == "gelu" else h

        lib_ms = device_ms(library)
        names = "; ".join(f"{kn[:90]} {kms:.4f} ms" for kn, kms in device_kernels(library))
        plain_ms = device_ms(plain)
        dev_ms = in_turns(runs)
        cur = libs["current"]
        apply_ms = device_ms(lambda: apply(cur))
        split_ms = device_ms(lambda: split(cur)) if cur.tf32x3 else float("nan")
        flop = 2.0 * m * k * n
        nbytes = 4.0 * (m * k + n * k + m * cols + 2 * k + (n if with_bias else 0))
        tc = 1e3 * max(flop / PEAK_F32_TC_FLOPS, nbytes / PEAK_BYTES_PER_S)
        fma = 1e3 * max(flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}, {launches} launches per UNet call: device earlier "
              f"{dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), current "
              f"{dev_ms['current'][0]:.4f} ms (runs {text['current']}; apply pass "
              f"{apply_ms:.4f}, weight split {split_ms:.4f}; "
              f"{flop / dev_ms['current'][0] / 1e9:.1f} TFLOP/s), PyTorch call (float32) "
              f"{lib_ms:.4f} ms [its kernels: {names}], plain twin {plain_ms:.4f} ms; bound "
              f"{tc:.4f} ms at 3xTF32, {fma:.4f} at FMA ({flop / 1e9:.1f} GFLOP)", flush=True)
        del x, wt, y, w2, out
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", type=Path, help="the earlier build's ln_matmul.cu")
    parser.add_argument("--timing-only", action="store_true",
                        help="time an earlier build that is not meant to be right: print its "
                             "errors, do not fail")
    parser.add_argument("--f32", action="store_true",
                        help="the float32 GEMM (dg_ln_gemm_f32) on float32 operands")
    parser.add_argument("--groups", default="",
                        help="comma-separated row-tile groups to time the current build with")
    args = parser.parse_args()
    groups = [int(v) for v in args.groups.split(",") if v]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's f32 product
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "ln_matmul.cu")}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if args.f32:
        return main_f32(libs, dev, g, stream, sms)
    totals = {"earlier": 0.0, "current": 0.0, "apply pass": 0.0, "PyTorch call": 0.0,
              "bound": 0.0}
    for (m, k, n, epi, with_bias, eps), launches in SHAPES.items():
        geglu = epi == "geglu"
        x = (torch.randn((m, k), generator=g, device=dev) * 2.0 + 0.5).bfloat16()
        wt = (torch.randn((n, k), generator=g, device=dev) * k ** -0.5).bfloat16()
        gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
        beta = 0.1 * torch.randn(k, generator=g, device=dev)
        bias = 0.1 * torch.randn(n, generator=g, device=dev) if with_bias else None
        bias_ptr = None if bias is None else bias.data_ptr()
        cols = n // 2 if geglu else n
        y = torch.empty_like(x)
        stats = torch.empty((m, 2), device=dev)
        out = torch.empty((m, cols), device=dev, dtype=torch.bfloat16)
        plan = lm.gemm_plan(m, n, geglu, sms)

        def apply(lib):
            checked(lib.dg_ln_apply(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                    y.data_ptr(), m, k, eps, 0, stream))

        def call(lib, group=plan.group):
            if not lib.split:
                return checked(lib.dg_ln_matmul_bf16(
                    x.data_ptr(), wt.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bias_ptr,
                    stats.data_ptr(), out.data_ptr(), m, n, k, eps, EPILOGUE[epi], stream))
            apply(lib)
            checked(lib.dg_ln_gemm(y.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(), m, n,
                                   k, EPILOGUE[epi], plan.blocks, group, stream))

        ref = lm.ln_matmul_reference(x.float(), wt.t().float(), gamma, beta, eps, bias, geglu,
                                     "gelu" if epi == "gelu" else "none").float()
        what = f"(M, K, N) = {(m, k, n)} {epi}{' + bias' if with_bias else ''}"
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
        g16, b16 = gamma.bfloat16(), beta.bfloat16()
        bias16 = None if bias is None else bias.bfloat16()

        def library():
            h = F.linear(F.layer_norm(x, (k,), g16, b16, eps), wt, bias16)
            if geglu:
                hidden, gate = h.chunk(2, dim=-1)
                return hidden * F.gelu(gate)
            return F.gelu(h) if epi == "gelu" else h

        lib_ms = device_ms(library)
        dev_ms = in_turns(runs)
        apply_ms = device_ms(lambda: apply(libs["current"])) if libs["current"].split else 0.0
        flop = 2.0 * m * k * n
        bound = 1e3 * flop / PEAK_BF16_FLOPS
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}, {launches} launches per UNet call: device earlier "
              f"{dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), current "
              f"{dev_ms['current'][0]:.4f} ms (runs {text['current']}; apply pass "
              f"{apply_ms:.4f}), PyTorch call {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({flop / 1e9:.1f} GFLOP; current at {flop / dev_ms['current'][0] / 1e9:.0f} "
              f"TFLOP/s, earlier at {flop / dev_ms['earlier'][0] / 1e9:.0f}); {plan.tiles_m} x "
              f"{plan.tiles_n} tiles on {plan.blocks} blocks", flush=True)
        if groups:
            times = {gr: [] for gr in groups}
            for _ in range(3):
                for gr in groups:
                    times[gr].append(device_ms(lambda: call(libs["current"], gr)))
            print(f"{what}: current build by row-tile group (device ms, median of 3; the plan's "
                  f"{plan.group}): " + ", ".join(f"{gr}: {statistics.median(t):.4f}"
                                                 for gr, t in times.items()), flush=True)
        for name, ms in (("earlier", dev_ms["earlier"][0]), ("current", dev_ms["current"][0]),
                         ("apply pass", apply_ms), ("PyTorch call", lib_ms), ("bound", bound)):
            totals[name] += ms * launches
        del x, wt, y, stats, out
        torch.cuda.empty_cache()
    print("per UNet call (median x launches, 70 launches, ms): "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
