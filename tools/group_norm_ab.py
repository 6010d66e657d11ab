#!/usr/bin/env python3
"""A/B of the NHWC GroupNorm kernel (kernel 7, ``fused_group_norm``) against an
earlier build, at every shape of an int8 SDXL UNet call, on one GPU.

Runs from the root of a checkout. Extract the earlier source first (the
machine that runs this needs no git), e.g. for the parent commit:

    mkdir -p build/scratch/old
    git show HEAD~1:divergen_tpu_torch/csrc/group_norm.cu > build/scratch/old/group_norm.cu
    python3 tools/group_norm_ab.py build/scratch/old/group_norm.cu

Builds that source and the checkout's ``csrc/group_norm.cu`` with nvcc, each
into a library of its own under ``build/scratch/`` (headers from the source's
own directory first, then ``csrc/``: put an earlier ``gn_moments.cuh`` beside
an earlier source to build it with that), and calls their ``dg_group_norm``
on the same seeded operands, scratch allocated once. A build with
``dg_group_norm_threads`` takes the plan of ``ops/group_norm.py:norm_plan``
(two passes); an earlier one the interface of the three-launch body (moments,
per-image finalize, apply) with ``moment_splits``' split count, so a variant
of the current source can be A/B'd as well.

Shapes: ``ops/group_norm.py:UNET_GROUP_NORMS`` (the 46 launches of a UNet call
at B = 2 images, 1024²), or ``--shape B,H,W,C[,silu]`` (repeatable), in bf16,
and with ``--f32`` in float32 too. For each it prints, for both builds, the
relative L2 and max |error| against ``group_norm_reference`` in float32 and
whether two runs give the same bits; then the device time of both in turns
(earlier, current, current, earlier, three times; each a
``chip_smoke.device_ms`` of 10 calls; medians of 6) beside that of
``F.group_norm`` (+ ``F.silu``) in x's dtype on the channels-last NCHW view,
and the bound (x read and y written once, scale and bias once, at 3.35 TB/s);
then the sums of median x launches over a UNet call. Needs a CUDA device;
prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ab_common import build, checked, in_turns
from chip_smoke import PEAK_BYTES_PER_S, card_line, device_ms
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import group_norm as gn

EPS = 1e-6


def load(name: str, src: Path) -> ctypes.CDLL:
    lib = build("group_norm_ab", name, src, report=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.planned = hasattr(lib, "dg_group_norm_threads")
    if lib.planned:
        lib.dg_group_norm.argtypes = [p] * 5 + [i] * 8 + [f, i, i, p]
    else:
        lib.dg_group_norm.argtypes = [p] * 6 + [i] * 5 + [f, i, i, p]
    return lib


def caller(lib, x, scale, bias, out, groups, silu, stream):
    """A call of this build's kernel on x, and the scratch it writes (allocated
    here: keep it while the call is used)."""
    b, h, w, c = x.shape
    f32 = int(x.dtype == torch.float32)
    if lib.planned:
        plan = gn.norm_plan(b, h * w, c)
        part = torch.empty((b, plan.splits, plan.ctiles, 2, groups), device=x.device)
        args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(), out.data_ptr(),
                b, h * w, c, groups, plan.tile_vecs, plan.rows, plan.ctiles, plan.splits, EPS,
                int(silu), f32, stream)
    else:
        splits = gn.moment_splits(b, h * w, c)
        part = torch.empty((b, splits, 2, c), device=x.device)
        stats = torch.empty((b, groups, 2), device=x.device)
        args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
                stats.data_ptr(), out.data_ptr(), b, h * w, c, groups, splits, EPS, int(silu),
                f32, stream)
        part = (part, stats)
    return lambda: checked(lib.dg_group_norm(*args)), part


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", type=Path, help="the earlier build's group_norm.cu")
    parser.add_argument("--shape", action="append", default=[], metavar="B,H,W,C[,silu]",
                        help="time this shape instead of the UNet's (repeatable; silu 0 or 1, "
                             "default 1)")
    parser.add_argument("--f32", action="store_true", help="float32 x as well as bf16")
    parser.add_argument("--timing-only", action="store_true",
                        help="time an earlier build that is not meant to be right: print its "
                             "errors, do not fail")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "group_norm.cu")}
    shapes = {}
    for text in args.shape:
        v = [int(t) for t in text.split(",")]
        shapes[(*v[:4], bool(v[4]) if len(v) > 4 else True)] = 1
    shapes = shapes or gn.UNET_GROUP_NORMS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.bfloat16, torch.float32) if args.f32 else (torch.bfloat16,):
        names = ("earlier", "current", "F.group_norm", "bound")
        totals = dict.fromkeys(names, 0.0)
        for (b, h, w, c, silu), launches in shapes.items():
            x = (torch.randn((b, h, w, c), generator=g, device=dev) * 2.0 + 0.5).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
            bias = 0.1 * torch.randn(c, generator=g, device=dev)
            groups = math.gcd(32, c)
            out = torch.empty_like(x)
            made = {name: caller(lib, x, scale, bias, out, groups, silu, stream)
                    for name, lib in libs.items()}
            calls = {name: call for name, (call, _) in made.items()}
            what = f"({b}, {h}, {w}, {c}) silu={silu} {str(dtype)[6:]}"
            ref = gn.group_norm_reference(x.float(), scale, bias, groups, EPS, silu)
            for name, call in calls.items():
                call()
                got = out.clone()
                call()
                same = torch.equal(got, out)
                diff = got.float() - ref
                rel = (diff.norm() / ref.norm()).item()
                err = diff.abs().max().item()
                print(f"{what} {name}: rel_l2 {rel:.3g} max_abs_err {err:.3g}; same bits twice: "
                      f"{same}", flush=True)
                if (not same or rel > 1e-2 or err > 3e-2 * ref.abs().max().item()
                        or not torch.isfinite(got).all()) and not (args.timing_only
                                                                   and name == "earlier"):
                    raise AssertionError(f"{name} build is wrong at {what}")
            del ref, got, diff
            dev_ms = in_turns(calls)
            nchw = x.permute(0, 3, 1, 2)
            s16, b16 = scale.to(dtype), bias.to(dtype)

            def library():
                y = F.group_norm(nchw, groups, s16, b16, EPS)
                return F.silu(y) if silu else y

            lib_ms = device_ms(library)
            nbytes = 2.0 * x.numel() * x.element_size() + 8.0 * c
            bound = 1e3 * nbytes / PEAK_BYTES_PER_S
            runs = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
            print(f"{what}, {launches} launches a UNet call: device earlier "
                  f"{dev_ms['earlier'][0]:.4f} ms (runs {runs['earlier']}), current "
                  f"{dev_ms['current'][0]:.4f} ms (runs {runs['current']}), F.group_norm"
                  f"{' + F.silu' if silu else ''} {lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB; current at {nbytes / dev_ms['current'][0] / 1e6:.0f} "
                  "GB/s)", flush=True)
            for name, ms in (("earlier", dev_ms["earlier"][0]), ("current", dev_ms["current"][0]),
                             ("F.group_norm", lib_ms), ("bound", bound)):
                totals[name] += ms * launches
            del x, out, made, calls, nchw
            torch.cuda.empty_cache()
        print(f"{str(dtype)[6:]}: sums of median x launches over {sum(shapes.values())} launches "
              "(ms): " + ", ".join(f"{name} {ms:.4f}" for name, ms in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
