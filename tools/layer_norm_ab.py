#!/usr/bin/env python3
"""A/B of the row LayerNorm kernel (kernel 9, ``fused_layer_norm``) against an
earlier build, at the shapes of an int8 SDXL UNet call, on one GPU.

Runs from the root of a checkout. Extract the earlier source first (the
machine that runs this needs no git), e.g. for the parent commit:

    mkdir -p build/scratch/old
    git show HEAD~1:divergen_tpu_torch/csrc/layer_norm.cu > build/scratch/old/layer_norm.cu
    python3 tools/layer_norm_ab.py build/scratch/old/layer_norm.cu

Builds that source and the checkout's ``csrc/layer_norm.cu`` with nvcc, each
into a library of its own under ``build/scratch/`` (headers from the source's
own directory first, then ``csrc/``), and calls their ``dg_layer_norm`` on the
same bf16 rows (a variant of the current source, changed in one place, can
be A/B'd the same way). Shapes: the UNet's transformer LayerNorms at 1024²
(UNet batch 4; an int8 UNet call runs 180 at (4096, 1280) and 30 at
(16384, 640)), or ``--shape ROWS,C`` (repeatable). For each it prints, for
both builds, the relative L2 and max |error| against ``layer_norm_reference``
in float32 and whether two runs give the same bits; then the device time of
both in turns (earlier, current, current, earlier, three times; each a
``chip_smoke.device_ms`` of 10 calls; medians of 6) beside that of
``F.layer_norm`` in bf16 and the bound (x read and y written once in bf16,
gamma and beta once in f32, at 3.35 TB/s); then the sums of median x
launches over a UNet call's 210. Needs a CUDA device; prints the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ab_common import build, checked, in_turns
from chip_smoke import PEAK_BYTES_PER_S, card_line, device_ms
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import layer_norm as ln

# (rows, C) -> launches per int8 UNet call at B = 2 images (UNet batch 4)
SHAPES = {(4096, 1280): 180, (16384, 640): 30}
EPS = 1e-5


def load(name: str, src: Path) -> ctypes.CDLL:
    lib = build("layer_norm_ab", name, src, report=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dg_layer_norm.argtypes = [p] * 4 + [i] * 2 + [f, i, p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", type=Path, help="the earlier build's source")
    parser.add_argument("--shape", action="append", default=[], metavar="ROWS,C",
                        help="time this (rows, C) instead of the UNet's shapes (repeatable)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "layer_norm.cu")}
    shapes = ({tuple(int(v) for v in text.split(",")): 0 for text in args.shape}
              if args.shape else SHAPES)
    totals = {"earlier": 0.0, "current": 0.0, "F.layer_norm": 0.0, "bound": 0.0}
    for (rows, c), launches in shapes.items():
        x = (3.0 * torch.randn((rows, c), generator=g, device=dev) + 1.0).bfloat16()
        gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        beta = 0.1 * torch.randn(c, generator=g, device=dev)
        ref = ln.layer_norm_reference(x.float(), gamma, beta, EPS)
        outs = {name: torch.empty_like(x) for name in libs}
        runs = {name: (lambda lib=lib, name=name: checked(lib.dg_layer_norm(
                    x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), outs[name].data_ptr(),
                    rows, c, EPS, 0, stream)))
                for name, lib in libs.items()}
        what = f"(rows, C) = {(rows, c)}"
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            got = outs[name].clone()
            run()
            torch.cuda.synchronize()
            same = torch.equal(got, outs[name])
            diff = got.float() - ref
            rel = (diff.norm() / ref.norm()).item()
            print(f"{what} {name}: rel_l2 {rel:.4g}, max_abs_err {diff.abs().max().item():.4g} "
                  f"(max|ref| {ref.abs().max().item():.4g}), same bits twice: {same}",
                  flush=True)
            if not torch.isfinite(got).all() or rel > 1e-2 or not same:
                raise AssertionError(f"{name} build is wrong at {what}")
        g16, b16 = gamma.bfloat16(), beta.bfloat16()
        dev_ms = in_turns(runs)
        lib_ms = device_ms(lambda: F.layer_norm(x, (c,), g16, b16, EPS))
        nbytes = 4.0 * rows * c + 8.0 * c
        bound = 1e3 * nbytes / PEAK_BYTES_PER_S
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}: device earlier {dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), "
              f"current {dev_ms['current'][0]:.4f} ms (runs {text['current']}), F.layer_norm "
              f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB; current at "
              f"{nbytes / dev_ms['current'][0] / 1e6:.0f} GB/s); "
              + (f"{launches} launches per int8 UNet call" if launches else "on no UNet call"),
              flush=True)
        for name in ("earlier", "current"):
            totals[name] += dev_ms[name][0] * launches
        totals["F.layer_norm"] += lib_ms * launches
        totals["bound"] += bound * launches
        del x, ref, outs
        torch.cuda.empty_cache()
    if not args.shape:
        print("per int8 UNet call (median x launches, ms): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
