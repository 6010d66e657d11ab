#!/usr/bin/env python3
"""A/B of the wgmma attention kernels against an earlier build, on one GPU:
SDXL's self-attention (kernel 1, ``flash_attention_packed`` at head dim 64)
at the shapes of an SDXL UNet call and the main shape, with ``--d512``
the VAE's mid attention (kernel 3, ``flash_attention`` at head dim 512), or
with ``--relpos`` SAM ViT-H's global attention (kernel 4,
``flash_attention_relpos`` at head dim 80, on heads-first views of the fused
(B, N, 3, 16, 80) projection, as ``modeling/backbone/vit.py`` calls it).

Runs from the root of a checkout. Extract the earlier source first (the
machine that runs this needs no git), e.g. an earlier commit's
``flash_attention.cu``, which held the mma.sync bodies at d = 64 and d = 512
before the wgmma ones replaced them:

    mkdir -p build/scratch/old
    git show HEAD~1:divergen_tpu_torch/csrc/flash_attention.cu > build/scratch/old/flash_attention.cu
    python3 tools/attention_ab.py build/scratch/old/flash_attention.cu          # d = 64
    python3 tools/attention_ab.py --d512 build/scratch/old/flash_attention.cu   # d = 512
    python3 tools/attention_ab.py --relpos build/scratch/old/flash_attention.cu # d = 80

(at d = 80 the earlier source is the mma.sync body of PR 12 and before, or a
variant of ``csrc/flash_attention_relpos_sm90.cu``; both have the entry
``dg_flash_attention_relpos_bf16``).

Builds that source and the checkout's ``csrc/flash_attention_sm90.cu`` (or
``csrc/flash_attention_d512.cu``, ``csrc/flash_attention_relpos_sm90.cu``) with nvcc, each into a library of its own
under ``build/scratch/`` (headers from the source's own directory first,
then ``csrc/``), and calls their C entry points on the same operands. An
earlier build has either the interface of the mma.sync body
(``dg_flash_attention``, strides) or the current one
(``dg_flash_attention_sm90`` / ``dg_flash_attention_d512``, tensor maps), so
a variant of the current source can be A/B'd as well.

``--shape`` (repeatable) times other shapes instead: B,N,C,H at d = 64,
BH,S (Sq = Sk = S) at d = 512, B,heads,H,W at d = 80. For each shape (bf16, seeded) it prints, for
both builds, the relative L2 and max |error| against the plain twin in
float32 (``reference_attention_packed`` / ``reference_attention``), the
elements that differ from the twin's bf16 result, and whether two runs give
the same bits; then the device time of both in turns (earlier, current,
current, earlier, three times; each a ``chip_smoke.device_ms`` of 10 calls,
3 at d = 512; medians of 6) beside that of ``scaled_dot_product_attention``
on the same q, k and v ((B, H, N, d) contiguous at d = 64), and the bound (4
B H N² d FLOP at 989 TFLOP/s). At d = 64, then the sums of median x
launches per UNet call; at d = 80 (relative-position bias factors of scale
0.7 against ``reference_attention_relpos``; SDPA with the dense bias built
outside the timing as a bf16 mask), the sum over a SAM forward's 4 launches.
With ``--f32`` the float32 body of kernels 1, 3, 4, 5 and 6
(``csrc/attention_f32.cu``, one C entry ``dg_attention_f32`` in every build
since it came in) at the shapes of full-width float32 models: kernel 3 at
(1, 16384, 512) and (1, 4096, 512) (a float32 ``VAEDecoder``'s mid
attention at 1024² and 512²), kernel 4 at (4, 16, 64 x 64, 80) (a float32
``SAM.vit_h()`` global layer), kernel 1 at (4, 4096, 640, 10) (a float32
``UNetSDXL()`` level-1 self-attention) and the window forward at Swin-L's
stage 1, (722, 6, n 144) with the mask; the earlier build is e.g. the parent's
``attention_f32.cu`` (``git show HEAD~1:divergen_tpu_torch/csrc/attention_f32.cu``).
Each is held against its float32 twin at ``chip_smoke.F32_BOUNDS`` (the
earlier build too, unless ``--timing-only``) and timed in turns, beside the
twin, the PyTorch float32 call (SDPA, the bias as a float32 mask; TF32 off)
with the names of its longest kernels, and the bounds at 3xTF32 and at FMA.
Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ab_common import build, in_turns
from chip_smoke import (F32_BOUNDS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_F32_FLOPS,
                        PEAK_F32_TC_FLOPS, card_line, compare, device_kernels, device_ms)
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import attention_f32 as af
from divergen_tpu_torch.ops import flash_attention as fa
from divergen_tpu_torch.ops import window_attention as wa

# (B, N, C, heads) -> launches per SDXL UNet call at B = 2 images (batch 4);
# None: the main shape of PERF.md's kernel table, on no UNet call
SHAPES = {(4, 4096, 640, 10): 10, (4, 1024, 1280, 20): 60, (2, 4096, 640, 10): None}
# (BH, S) of the d = 512 attention: the VAE's mid block at 1024² (one launch
# per decoded image), and at 512²
D512_SHAPES = ((1, 16384), (1, 4096))
# (B, heads, H, W) of the d = 80 relative-position attention: SAM ViT-H's
# global layers at 1024² and batch 4 (4 launches per forward), and batch 1
RELPOS_SHAPES = ((4, 16, 64, 64), (1, 16, 64, 64))
SAM_RELPOS_LAUNCHES = 4
# the float32 body's full-width cases (--f32): (kind, shape)
F32_SHAPES = (("flash", (1, 16384, 512)), ("flash", (1, 4096, 512)),
              ("relpos", (4, 16, 64, 64, 80)), ("packed", (4, 4096, 640, 10)),
              ("window", (722, 6, 361, 144)))


def load(name: str, src: Path) -> ctypes.CDLL:
    lib = build("attention_ab", name, src, report=True)
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    if hasattr(lib, "dg_flash_attention_relpos_bf16"):
        lib.dg_flash_attention_relpos_bf16.argtypes = [p] * 6 + [i] * 5 + [i64] * 9 + [f, p]
    lib.sm90 = hasattr(lib, "dg_flash_attention_sm90")
    lib.d512 = hasattr(lib, "dg_flash_attention_d512")
    if lib.sm90:
        lib.dg_flash_attention_sm90.argtypes = ([p] * 5 + [i] * 4 + [i64] * 4 + [i] * 4
                                                + [i64] * 6 + [f, i, i, p])
    elif lib.d512:
        lib.dg_flash_attention_d512.argtypes = ([p] * 5 + [i] * 4 + [i64] * 4 + [i] * 4
                                                + [i64] * 6 + [f, i, i, p])
    elif hasattr(lib, "dg_flash_attention"):
        lib.dg_flash_attention.argtypes = [p] * 5 + [i] * 5 + [i64] * 12 + [f, i, p]
    return lib


def call(lib, qkv: torch.Tensor, heads: int, out: torch.Tensor, stream: int, sms: int) -> None:
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    ptr = qkv.data_ptr()
    if lib.sm90:
        plan = fa.packed_plan(b, n, c, heads)
        code = lib.dg_flash_attention_sm90(
            ptr, ptr, ptr, None, out.data_ptr(), b, heads, n, n, plan.width, n * c3,
            plan.width, n * c3, plan.q_c0, plan.k_c0, plan.v_c0, plan.head_c, n * c, d, c,
            0, 0, 0, 1.0 / math.sqrt(d), 0, sms, stream)
    else:
        code = lib.dg_flash_attention(
            ptr, ptr + 2 * c, ptr + 4 * c, None, out.data_ptr(), b, heads, n, n, d,
            n * c3, d, c3, n * c3, d, c3, n * c, d, c, 0, 0, 0, 1.0 / math.sqrt(d), 0, stream)
    if code:
        raise RuntimeError(f"launch failed with CUDA error {code}")


def call_d512(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
              stream: int, sms: int) -> None:
    bh, sq, d = q.shape
    sk = k.shape[1]
    if lib.d512:
        code = lib.dg_flash_attention_d512(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), bh, 1, sq, sk, d,
            sq * d, d, sk * d, 0, 0, 0, 0, sq * d, 0, d, 0, 0, 0, 1.0 / math.sqrt(d), 0,
            sms, stream)
    else:
        code = lib.dg_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), bh, 1, sq, sk, d,
            sq * d, 0, d, sk * d, 0, d, sq * d, 0, d, 0, 0, 0, 1.0 / math.sqrt(d), 0, stream)
    if code:
        raise RuntimeError(f"launch failed with CUDA error {code}")


def call_relpos(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bh_t: torch.Tensor,
                bw_t: torch.Tensor, hw, out: torch.Tensor, stream: int) -> None:
    """q, k, v (B, heads, N, 80) views sharing strides; out a (B, heads, N,
    80) view; the factors contiguous (B·heads, H|W, N) f32."""
    b, heads, _, d = q.shape
    st = lambda t: (t.stride(0), t.stride(1), t.stride(2))
    code = lib.dg_flash_attention_relpos_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bh_t.data_ptr(), bw_t.data_ptr(),
        out.data_ptr(), b, heads, hw[0], hw[1], d, *st(q), *st(k), *st(out),
        1.0 / math.sqrt(d), stream)
    if code:
        raise RuntimeError(f"launch failed with CUDA error {code}")


def check(name: str, what: str, run, got_fn, ref: torch.Tensor, timing_only: bool) -> None:
    """Two runs of ``run``: their errors against ``ref`` and whether they
    give the same bits; raises if the build is wrong (unless it is the
    earlier one and ``timing_only``)."""
    run()
    torch.cuda.synchronize()
    got = got_fn().clone()
    run()
    torch.cuda.synchronize()
    same = torch.equal(got, got_fn())
    diff = got.float() - ref
    rel = (diff.norm() / ref.norm()).item()
    print(f"{what} {name}: rel_l2 {rel:.4g}, max_abs_err {diff.abs().max().item():.4g} "
          f"(max|ref| {ref.abs().max().item():.4g}), elements differing from the "
          f"plain twin's bf16 result {int((got != ref.bfloat16()).sum())} of {got.numel()}, "
          f"same bits twice: {same}", flush=True)
    wrong = not torch.isfinite(got).all() or rel > 1e-2 or not same
    if wrong and not (timing_only and name == "earlier"):
        raise AssertionError(f"{name} build is wrong at {what}")


def main_d512(args, dev: torch.device, g: torch.Generator, stream: int, sms: int) -> int:
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "flash_attention_d512.cu")}
    shapes = ([tuple(int(v) for v in text.split(",")) for text in args.shape]
              if args.shape else D512_SHAPES)
    d = 512
    for bh, n in shapes:
        q, k, v = (torch.randn((bh, n, d), generator=g, device=dev).bfloat16() for _ in range(3))
        ref = fa.reference_attention(q.float(), k.float(), v.float())
        outs = {name: torch.empty_like(q) for name in libs}
        runs = {name: (lambda lib=lib, name=name: call_d512(lib, q, k, v, outs[name], stream,
                                                              sms))
                for name, lib in libs.items()}
        what = f"(BH, S, d) = {(bh, n, d)}"
        for name, run in runs.items():
            check(name, what, run, lambda name=name: outs[name], ref, args.timing_only)
        del ref
        torch.cuda.empty_cache()
        dev_ms = in_turns(runs, timer=lambda fn: device_ms(fn, reps=3))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
                         reps=3)
        flop = 4.0 * bh * n * n * d
        bound = 1e3 * flop / PEAK_BF16_FLOPS
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}: device earlier {dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), "
              f"current {dev_ms['current'][0]:.4f} ms (runs {text['current']}), SDPA "
              f"{sdpa:.4f} ms, bound {bound:.4f} ms ({flop / 1e9:.1f} GFLOP; current at "
              f"{flop / dev_ms['current'][0] / 1e9:.0f} TFLOP/s)", flush=True)
        del q, k, v, outs
        torch.cuda.empty_cache()
    return 0


def main_relpos(args, dev: torch.device, g: torch.Generator, stream: int) -> int:
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "flash_attention_relpos_sm90.cu")}
    shapes = ([tuple(int(v) for v in text.split(",")) for text in args.shape]
              if args.shape else RELPOS_SHAPES)
    d = 80
    for b, heads, h, w in shapes:
        n, bh = h * w, b * heads
        qkv = torch.randn((b, n, 3, heads, d), generator=g, device=dev).bfloat16()
        q, k, v = (qkv[:, :, s].permute(0, 2, 1, 3) for s in range(3))
        bh_t = 0.7 * torch.randn((bh, h, n), generator=g, device=dev)
        bw_t = 0.7 * torch.randn((bh, w, n), generator=g, device=dev)
        ref = fa.reference_attention_relpos(*(t.reshape(bh, n, d).float() for t in (q, k, v)),
                                            bh_t, bw_t, (h, w)).reshape(b, heads, n, d)
        outs = {name: torch.empty((b, n, heads, d), device=dev,
                                  dtype=torch.bfloat16).permute(0, 2, 1, 3) for name in libs}
        runs = {name: (lambda lib=lib, name=name: call_relpos(lib, q, k, v, bh_t, bw_t, (h, w),
                                                                outs[name], stream))
                for name, lib in libs.items()}
        what = f"(B, heads, H, W, d) = {(b, heads, h, w, d)}"
        for name, run in runs.items():
            check(name, what, run, lambda name=name: outs[name], ref, args.timing_only)
        del ref
        mask = fa.relpos_dense_bias(bh_t, bw_t).bfloat16().contiguous().reshape(b, heads, n, n)
        dev_ms = in_turns(runs)
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        flop = 4.0 * bh * n * n * d
        bound = 1e3 * flop / PEAK_BF16_FLOPS
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}: device earlier {dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), "
              f"current {dev_ms['current'][0]:.4f} ms (runs {text['current']}), SDPA "
              f"{sdpa:.4f} ms, bound {bound:.4f} ms ({flop / 1e9:.1f} GFLOP; current at "
              f"{flop / dev_ms['current'][0] / 1e9:.0f} TFLOP/s); per SAM forward "
              f"({SAM_RELPOS_LAUNCHES} launches): earlier "
              f"{dev_ms['earlier'][0] * SAM_RELPOS_LAUNCHES:.3f} ms, current "
              f"{dev_ms['current'][0] * SAM_RELPOS_LAUNCHES:.3f} ms", flush=True)
        del qkv, q, k, v, outs, mask
        torch.cuda.empty_cache()
    return 0


def f32_case(kind, shape, dev, g):
    """The operands of one float32 case: (the C entry's arguments bar the
    output and the stream, the output, the plain twin, the PyTorch call,
    FLOP, bytes)."""
    randn = lambda *sh, scale=1.0: torch.randn(sh, generator=g, device=dev) * scale
    st = lambda t: (t.stride(0), t.stride(1), t.stride(2))
    if kind == "flash":
        bh, n, d = shape
        q, k, v = (randn(bh, n, d) for _ in range(3))
        out = torch.empty_like(q)
        args = dict(q=q, k=k.data_ptr(), v=v.data_ptr(), mode="none", bias=None, bias2=None,
                    batch=bh, heads=1, sq=n, sk=n, d=d, qs=(n * d, 0, d), kvs=(n * d, 0, d),
                    os=(n * d, 0, d), grid=(0, 0), nw=1)
        plain = lambda: fa.reference_attention(q, k, v)
        library = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])
        return args, out, plain, library, 4.0 * bh * n * n * d, 16.0 * bh * n * d
    if kind == "relpos":
        b, heads, h, w, d = shape
        n = h * w
        fused = randn(b, n, 3, heads, d)
        q, k, v = (fused[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        bh_t, bw_t = randn(b * heads, h, n, scale=0.7), randn(b * heads, w, n, scale=0.7)
        out = torch.empty((b, heads, n, d), device=dev)
        args = dict(q=q, k=k.data_ptr(), v=v.data_ptr(), mode="relpos", bias=bh_t, bias2=bw_t,
                    batch=b, heads=heads, sq=n, sk=n, d=d, qs=st(q), kvs=st(k), os=st(out),
                    grid=(h, w), nw=1)
        plain = lambda: fa.reference_attention_relpos(
            *(t.reshape(b * heads, n, d) for t in (q, k, v)), bh_t, bw_t,
            (h, w)).reshape(b, heads, n, d)
        dense = fa.relpos_dense_bias(bh_t, bw_t).contiguous().reshape(b, heads, n, n)
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense)
        return (args, out, plain, library, 4.0 * b * heads * n * n * d,
                16.0 * b * heads * n * d + 4.0 * b * heads * (h + w) * n)
    if kind == "packed":
        b, n, c, heads = shape
        bias = mask = None
        nw = 1
    else:
        bn, heads, nw, n = shape
        b, c = bn, 32 * heads
        bias = randn(heads, n, n, scale=0.5)
        mask = torch.where(torch.rand((nw, n, n), generator=g, device=dev) < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
    d = c // heads
    qkv = randn(b, n, 3 * c)
    out = torch.empty((b, n, c), device=dev)
    strides = (n * 3 * c, d, 3 * c)
    args = dict(q=qkv, k=qkv.data_ptr() + 4 * c, v=qkv.data_ptr() + 8 * c,
                mode="none" if kind == "packed" else "window", bias=bias, bias2=mask, batch=b,
                heads=heads, sq=n, sk=n, d=d, qs=strides, kvs=strides, os=(n * c, d, c),
                grid=(0, 0), nw=nw)
    q4, k4, v4 = (t.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()
                  for t in qkv.chunk(3, dim=-1))
    if kind == "packed":
        plain = lambda: fa.reference_attention_packed(qkv, heads)
        library = lambda: F.scaled_dot_product_attention(q4, k4, v4)
        nbytes = 16.0 * b * n * c
    else:
        plain = lambda: wa.reference_window_attention_packed(qkv, bias, mask, heads)
        win_mask = (bias[None] + mask.repeat(b // nw, 1, 1)[:, None]).contiguous()
        library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask)
        nbytes = 16.0 * b * n * c + 4.0 * (heads + nw) * n * n
    return args, out, plain, library, 4.0 * b * n * n * c, nbytes


def call_f32(lib, a: dict, out: torch.Tensor, stream: int) -> None:
    code = lib.dg_attention_f32(
        a["q"].data_ptr(), a["k"], a["v"], out.data_ptr(),
        None if a["bias"] is None else a["bias"].data_ptr(),
        None if a["bias2"] is None else a["bias2"].data_ptr(), af.BIAS_MODES[a["mode"]], a["d"],
        a["batch"], a["heads"], a["sq"], a["sk"], *a["qs"], *a["kvs"], *a["os"], 0, 0, 0,
        *a["grid"], a["nw"], 1.0 / math.sqrt(a["d"]), stream)
    if code:
        raise RuntimeError(f"launch failed with CUDA error {code}")


def main_f32(args, dev: torch.device, g: torch.Generator, stream: int) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins' float32 products
    libs = {"earlier": build("attention_ab", "earlier", args.earlier.resolve(), report=True),
            "current": build("attention_ab", "current", _build.CSRC / "attention_f32.cu",
                             report=True)}
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    for lib in libs.values():
        lib.dg_attention_f32.argtypes = [p] * 6 + [i] * 6 + [i64] * 12 + [i] * 3 + [f, p]
    for kind, shape in F32_SHAPES:
        a, out, plain, library, flop, nbytes = f32_case(kind, shape, dev, g)
        ref = plain()
        outs = {name: torch.empty_like(out) for name in libs}
        runs = {name: (lambda lib=lib, name=name: call_f32(lib, a, outs[name], stream))
                for name, lib in libs.items()}
        what = f"float32 {kind} {shape}"
        for name, run in runs.items():
            run()
            got = outs[name].clone()
            run()
            same = torch.equal(got, outs[name])
            try:
                compare(f"{what} {name}", got, ref, **F32_BOUNDS)
                ok = True
            except AssertionError:
                ok = False
            print(f"    same bits twice: {same}", flush=True)
            if not (ok and same) and not (args.timing_only and name == "earlier"):
                raise AssertionError(f"{name} build is wrong at {what}")
        del ref
        torch.cuda.empty_cache()
        dev_ms = in_turns(runs, timer=lambda fn: device_ms(fn, reps=3))
        lib_ms = device_ms(library, reps=3)
        names = "; ".join(f"{n[:90]} {ms:.4f} ms" for n, ms in device_kernels(library))
        plain_ms = device_ms(plain, reps=3)
        tc = 1e3 * max(flop / PEAK_F32_TC_FLOPS, nbytes / PEAK_BYTES_PER_S)
        fma = 1e3 * max(flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}: device earlier {dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), "
              f"current {dev_ms['current'][0]:.4f} ms (runs {text['current']}; "
              f"{flop / dev_ms['current'][0] / 1e9:.1f} TFLOP/s), PyTorch call (float32) "
              f"{lib_ms:.4f} ms [its kernels: {names}], plain twin {plain_ms:.4f} ms; bound {tc:.4f} ms at 3xTF32, {fma:.4f} at FMA ({flop / 1e9:.1f} GFLOP)",
              flush=True)
        del a, out, outs
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", type=Path, help="the earlier build's source")
    parser.add_argument("--d512", action="store_true",
                        help="the d = 512 body (kernel 3) in place of the d = 64 one")
    parser.add_argument("--relpos", action="store_true",
                        help="the d = 80 relative-position body (kernel 4) in place of the "
                             "d = 64 one")
    parser.add_argument("--f32", action="store_true",
                        help="the float32 body (attention_f32.cu) of kernels 1, 3, 4, 5 and 6 "
                             "at full-width float32 shapes")
    parser.add_argument("--shape", action="append", default=[],
                        metavar="B,N,C,H | BH,S | B,heads,H,W",
                        help="time this (B, N, C, heads), with --d512 (BH, S), with --relpos "
                             "(B, heads, H, W), instead of the default shapes (repeatable; no "
                             "launches per UNet call)")
    parser.add_argument("--timing-only", action="store_true",
                        help="time an earlier build that is not meant to be right (a body with "
                             "parts cut out, to see what they cost): print its errors, do not fail")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if args.f32:
        return main_f32(args, dev, g, stream)
    if args.d512:
        return main_d512(args, dev, g, stream, sms)
    if args.relpos:
        return main_relpos(args, dev, g, stream)
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "flash_attention_sm90.cu")}
    totals = {"earlier": 0.0, "current": 0.0, "SDPA": 0.0, "bound": 0.0}
    shapes = ({tuple(int(v) for v in text.split(",")): None for text in args.shape}
              if args.shape else SHAPES)
    for (b, n, c, heads), launches in shapes.items():
        d = c // heads
        qkv = torch.randn((b, n, 3 * c), generator=g, device=dev).bfloat16()
        ref = fa.reference_attention_packed(qkv.float(), heads)
        outs = {name: torch.empty((b, n, c), device=dev, dtype=torch.bfloat16) for name in libs}
        runs = {name: (lambda lib=lib, name=name: call(lib, qkv, heads, outs[name], stream, sms))
                for name, lib in libs.items()}
        what = f"(B, N, C, H) = {(b, n, c, heads)}"
        for name, run in runs.items():
            check(name, what, run, lambda name=name: outs[name], ref, args.timing_only)
        del ref
        q4, k4, v4 = (t.reshape(b, n, heads, d).transpose(1, 2).contiguous()
                      for t in qkv.chunk(3, dim=-1))
        dev_ms = in_turns(runs)
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        flop = 4.0 * b * heads * n * n * d
        bound = 1e3 * flop / PEAK_BF16_FLOPS
        text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
        print(f"{what}: device earlier {dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), "
              f"current {dev_ms['current'][0]:.4f} ms (runs {text['current']}), SDPA "
              f"{sdpa:.4f} ms, bound {bound:.4f} ms ({flop / 1e9:.1f} GFLOP; current at "
              f"{flop / dev_ms['current'][0] / 1e9:.0f} TFLOP/s); "
              + (f"{launches} launches per UNet call" if launches else "on no UNet call"),
              flush=True)
        if launches:
            for name in ("earlier", "current"):
                totals[name] += dev_ms[name][0] * launches
            totals["SDPA"] += sdpa * launches
            totals["bound"] += bound * launches
        del qkv, q4, k4, v4, outs
        torch.cuda.empty_cache()
    if not args.shape:
        print("per UNet call (median x launches, ms): "
              + ", ".join(f"{name} {ms:.3f}" for name, ms in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
