#!/usr/bin/env python3
"""A/B of the bf16 window-attention kernels (kernels 5 and 6,
``fused_window_attention_packed`` and ``fused_window_attention``, one body
each way), backward or, with ``--forward``, forward, against an earlier build,
at the four Swin-L stage shapes of the flagship detector, on one GPU; with
``--f32``, of the float32 backward body (``csrc/attention_f32.cu``) against
an earlier ``attention_f32.cu``, at those shapes and the smoke shape
(bn 8, 6 heads, nW 4).

Runs from the root of a checkout. Extract the earlier source first (the
machine that runs this needs no git), e.g. for the parent commit:

    mkdir -p build/scratch/old
    git show HEAD~1:divergen_tpu_torch/csrc/window_attention.cu \\
        > build/scratch/old/window_attention.cu
    python3 tools/window_attention_ab.py build/scratch/old/window_attention.cu [--forward]

Builds that source and the checkout's ``csrc/window_attention.cu`` with nvcc,
each into a library of its own under ``build/scratch/`` (headers from the
source's own directory first, then ``csrc/``), and calls their packed entry
point on the same seeded bf16 operands, scratch allocated once.

Backward (``dg_window_attention_packed_bwd_bf16``, the interface both bodies
share): a build with ``dg_window_attention_bwd_smem`` takes the chunks of
``ops/window_attention.py:backward_plan`` for the shared memory that entry
point reports, an earlier one about a block per multiprocessor; ``--chunks``
forces the current build's chunks per head. Forward
(``dg_window_attention_packed_bf16``): a build with
``dg_window_attention_fwd_smem`` takes its grid from ``forward_plan`` (for the
shared memory it reports; ``--chunks`` forces the current build's), an
earlier one (one block per window and head) none. Float32 backward
(``--f32``; ``dg_window_attention_packed_bwd_f32``): a build with
``dg_window_attention_bwd_f32_smem`` takes the interface with the head dim and
``f32_backward_plan``'s chunks, an earlier one (PR 11's CUDA-core body) its
interface without it and about a block per multiprocessor; each is held to the
float32 twin at ``chip_smoke.F32_BOUNDS``, and timed in turns beside SDPA's
float32 backward (TF32 off) and the bound at 3xTF32 (``PEAK_F32_TC_FLOPS``).
``--variant NAME=PATH[:MACRO,...]`` (repeatable) adds another
``attention_f32.cu``, for example a copy of the current one changed in one
place, built with ``-DMACRO`` for each macro, all builds in parallel, and
times it in the same turns (a name ending in ``!`` is timing only: its
errors are printed, not held).

Shapes: Swin-L at B = 2, 896², window 12 (n 144, d 32), with and without the
shift mask: (bn, heads) = (722, 6), (200, 12), (50, 24), (18, 48). For each
it prints, for both builds, the relative L2 and max |error| of each output
(dq, dk, dv and the float32 dbias; or o) against the plain version on the same
bf16 inputs (bound: relative L2 <= 1e-2, max |error| <= 3e-2 max |reference|)
and whether two runs give the same bits; then the device time of both in
turns (earlier, current, current, earlier, three times; each a
``chip_smoke.device_ms`` of 10 calls; medians of 6) beside that of
``scaled_dot_product_attention`` on the same q, k, v (and do) with its dense
bias + mask built outside the timing (its backward alone, without a bias
gradient; or its forward) and the bound (bytes of every input and output at
3.35 TB/s against the products at 989 TFLOP/s). Then the sums over the
24 launches of a train step's backward or of a Swin-L forward: 2, 2, 18 and
2 at the four stages, the mask on every second. ``--timing-only`` times an
earlier build that is not meant to be right; ``--windows 722,50`` runs only
those stages. Needs a CUDA device; prints the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ab_common import build, checked, in_turns
from chip_smoke import (F32_BOUNDS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_F32_TC_FLOPS,
                        card_line, device_ms)
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import window_attention as wa

# (bn, C, heads, nW) of Swin-L's four stages at B = 2, 896², window 12 -> launches a step
STAGES = {(722, 192, 6, 361): 2, (200, 384, 12, 100): 2, (50, 768, 24, 25): 18,
          (18, 1536, 48, 9): 2}
N = 144


def load(name: str, src: Path) -> ctypes.CDLL:
    lib = build("window_attention_ab", name, src, report=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dg_window_attention_packed_bwd_bf16.argtypes = [p] * 7 + [i] * 6 + [f, p]
    lib.planned = hasattr(lib, "dg_window_attention_bwd_smem")
    if lib.planned:
        lib.dg_window_attention_bwd_smem.argtypes = [i]
    lib.fwd_planned = hasattr(lib, "dg_window_attention_fwd_smem")
    lib.dg_window_attention_packed_bf16.argtypes = (
        [p] * 4 + [i] * (6 if lib.fwd_planned else 4) + [f, p])
    if lib.fwd_planned:
        lib.dg_window_attention_fwd_smem.argtypes = [i]
    return lib


def forward_grid(lib, bn: int, heads: int, dev: torch.device, chunks: int = 0) -> tuple:
    """The (chunks, windows per chunk) this build's forward takes, () for a
    build without a plan."""
    if not lib.fwd_planned:
        return ()
    if chunks:
        per = -(-bn // chunks)
        return -(-bn // per), per
    return tuple(wa.forward_plan(bn, heads, N, dev, smem=lib.dg_window_attention_fwd_smem(N)))


def inputs(g, bn: int, c: int, heads: int, nw: int, with_mask: bool, dev: torch.device):
    """Seeded qkv (bn, N, 3C) bf16, bias (heads, N, N) and a shift-like mask
    (about a third of the pairs closed, the diagonal open) or None."""
    qkv = torch.randn((bn, N, 3 * c), generator=g, device=dev).bfloat16()
    bias = 0.5 * torch.randn((heads, N, N), generator=g, device=dev)
    mask = None
    if with_mask:
        mask = torch.where(torch.rand((nw, N, N), generator=g, device=dev) < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
    return qkv, bias, mask


def held(what: str, name: str, parts, same: bool, timing_only: bool,
         rel_l2_bound: float = 1e-2, max_abs_bound: float = 3e-2) -> None:
    """Print each part's error against its reference; raise if a part is out
    of bounds or two runs differ (unless an earlier build is only timed)."""
    wrong = not same
    text = []
    for part, x, ref in parts:
        diff = x.float() - ref
        rel = (diff.norm() / ref.norm()).item()
        err = diff.abs().max().item()
        text.append(f"{part} rel_l2 {rel:.3g} max_abs_err {err:.3g}")
        wrong |= (not torch.isfinite(x).all() or rel > rel_l2_bound
                  or err > max_abs_bound * ref.abs().max().item())
    print(f"{what} {name}: {'; '.join(text)}; same bits twice: {same}", flush=True)
    if wrong and not (timing_only and name == "earlier" or name.endswith("!")):
        raise AssertionError(f"{name} build is wrong at {what}")


def run_forward(args, libs, only, dev, g) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    names = ("earlier", "current", "SDPA", "bound")
    totals = dict.fromkeys(names, 0.0)
    for (bn, c, heads, nw), launches in STAGES.items():
        if only and bn not in only:
            continue
        for with_mask in (True, False):
            d = c // heads
            qkv, bias, mask = inputs(g, bn, c, heads, nw, with_mask, dev)
            out = torch.empty((bn, N, c), device=dev, dtype=torch.bfloat16)
            grids = {"earlier": forward_grid(libs["earlier"], bn, heads, dev),
                     "current": forward_grid(libs["current"], bn, heads, dev, args.chunks)}

            def call(name):
                checked(libs[name].dg_window_attention_packed_bf16(
                    qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
                    out.data_ptr(), bn, N, heads, nw if mask is not None else 1, *grids[name],
                    d ** -0.5, stream))

            what = f"bn={bn} C={c} H={heads} n={N} mask={'nW ' + str(nw) if with_mask else 'none'}"
            ref = wa.reference_window_attention_packed(qkv.float(), bias, mask, heads).float()
            got = {}
            for name in ("earlier", "current"):
                call(name)
                got[name] = out.clone()
                call(name)
                held(f"{what} (grid {grids[name] or 'a block a window and head'})", name,
                     [("o", got[name], ref)], torch.equal(got[name], out), args.timing_only)
            diff = (got["current"].float() - got["earlier"].float()).abs()
            print(f"  current against earlier: {int((diff > 0).sum())} of {diff.numel()} elements "
                  f"differ, max {diff.max().item():.3g}", flush=True)
            del ref, got, diff
            dev_ms = in_turns({name: (lambda name=name: call(name)) for name in ("earlier", "current")})
            q4, k4, v4 = (qkv[..., i * c:(i + 1) * c].reshape(bn, N, heads, d).transpose(1, 2)
                          .contiguous() for i in range(3))
            dense = bias[None].expand(bn, -1, -1, -1)
            if mask is not None:
                dense = dense + mask.repeat(bn // nw, 1, 1)[:, None]
            dense = dense.bfloat16().contiguous()
            sdpa = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=dense))
            del q4, k4, v4, dense
            ops = 4.0 * bn * heads * N * N * d
            nbytes = (2.0 * bn * N * 4 * c + 4.0 * heads * N * N
                      + (4.0 * nw * N * N if with_mask else 0.0))
            bound = 1e3 * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
            runs = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
            print(f"{what}, {launches // 2} launches a Swin-L forward: device earlier "
                  f"{dev_ms['earlier'][0]:.4f} ms (runs {runs['earlier']}), current "
                  f"{dev_ms['current'][0]:.4f} ms (runs {runs['current']}), SDPA {sdpa:.4f} ms, "
                  f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP; current at "
                  f"{nbytes / dev_ms['current'][0] / 1e6:.0f} GB/s)", flush=True)
            for name, ms in (("earlier", dev_ms["earlier"][0]), ("current", dev_ms["current"][0]),
                             ("SDPA", sdpa), ("bound", bound)):
                totals[name] += ms * launches / 2
            del qkv, bias, mask, out
            torch.cuda.empty_cache()
    print("a Swin-L forward's 24 launches (median x launches, ms): "
          + ", ".join(f"{name} {ms:.4f}" for name, ms in totals.items()), flush=True)


def one_block_an_sm(bn: int, heads: int, dev: torch.device) -> tuple:
    """(chunks, windows per chunk) of the earlier bodies that planned about
    one block per multiprocessor."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = -(-bn // min(bn, max(1, -(-sms // heads))))
    return -(-bn // per), per


def plan(lib, bn: int, heads: int, dev: torch.device, chunks: int = 0) -> tuple:
    """(chunks, windows per chunk) this build is launched with."""
    if not lib.planned:
        return one_block_an_sm(bn, heads, dev)
    if chunks:
        per = -(-bn // chunks)
        return -(-bn // per), per
    got = wa.backward_plan(bn, heads, N, dev, smem=lib.dg_window_attention_bwd_smem(N))
    return got.chunks, got.per_chunk


F32_SHAPES = {**STAGES, (8, 192, 6, 4): 0}  # and the smoke shape


def load_f32(name: str, src: Path, macros=()) -> ctypes.CDLL:
    lib = build("window_attention_ab_f32", name.rstrip("!"), src, report=True,
                flags=[f"-D{m}" for m in macros])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.planned = hasattr(lib, "dg_window_attention_bwd_f32_smem")
    lib.dg_window_attention_packed_bwd_f32.argtypes = (
        [p] * 7 + [i] * (7 if lib.planned else 6) + [f, p])
    return lib


def run_f32(args, libs, only, dev, g) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    totals = {}
    for (bn, c, heads, nw), launches in F32_SHAPES.items():
        if only and bn not in only:
            continue
        for with_mask in (True, False):
            d = c // heads
            qkv, bias, mask = inputs(g, bn, c, heads, nw, with_mask, dev)
            qkv = torch.randn((bn, N, 3 * c), generator=g, device=dev)
            do = torch.randn((bn, N, c), generator=g, device=dev)
            dqkv = torch.empty_like(qkv)
            dbias = torch.empty((heads, N, N), device=dev)
            plans = {}
            for name, lib in libs.items():
                if not lib.planned:
                    plans[name] = one_block_an_sm(bn, heads, dev)
                elif args.chunks:
                    per = -(-bn // args.chunks)
                    plans[name] = (-(-bn // per), per)
                else:
                    plans[name] = tuple(wa.f32_backward_plan(bn, heads, N, d, dev)[:2])
            scratch = {name: torch.empty((ch if ch > 1 else 0, heads, N, N), device=dev)
                       for name, (ch, _) in plans.items()}

            def call(name):
                chunks, per = plans[name]
                lib = libs[name]
                checked(lib.dg_window_attention_packed_bwd_f32(
                    qkv.data_ptr(), do.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
                    dbias.data_ptr(), scratch[name].data_ptr(), bn, N, heads,
                    *((d,) if lib.planned else ()), nw if mask is not None else 1, chunks, per,
                    d ** -0.5, stream))

            what = f"float32 bn={bn} C={c} H={heads} n={N} mask={'nW ' + str(nw) if with_mask else 'none'}"
            ref_dqkv, ref_dbias = wa.reference_window_attention_packed_backward(
                qkv, bias, mask, heads, do)
            for name in libs:
                call(name)
                got = (dqkv.clone(), dbias.clone())
                call(name)
                same = torch.equal(got[0], dqkv) and torch.equal(got[1], dbias)
                parts = [(f"d{s}", got[0][..., i * c:(i + 1) * c], ref_dqkv[..., i * c:(i + 1) * c])
                         for i, s in enumerate("qkv")] + [("dbias", got[1], ref_dbias)]
                held(f"{what} (chunks {plans[name][0]} x {plans[name][1]} windows)", name, parts,
                     same, args.timing_only, **F32_BOUNDS)
            del ref_dqkv, ref_dbias, got
            dev_ms = in_turns({name: (lambda name=name: call(name)) for name in libs},
                              order=(*libs, *reversed(libs)))
            q4, k4, v4 = (qkv[..., i * c:(i + 1) * c].reshape(bn, N, heads, d).transpose(1, 2)
                          .contiguous().requires_grad_(True) for i in range(3))
            dense = bias[None].expand(bn, -1, -1, -1)
            if mask is not None:
                dense = dense + mask.repeat(bn // nw, 1, 1)[:, None]
            dense = dense.contiguous()
            do4 = do.reshape(bn, N, heads, d).transpose(1, 2).contiguous()
            out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=dense)
            sdpa = device_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                         retain_graph=True))
            del q4, k4, v4, dense, do4, out4
            ops = 5 * 2.0 * bn * heads * N * N * d
            nbytes = 4.0 * bn * N * 7 * c + 4.0 * (2 * heads + (nw if with_mask else 0)) * N * N
            bound = 1e3 * max(ops / PEAK_F32_TC_FLOPS, nbytes / PEAK_BYTES_PER_S)
            runs_text = ", ".join(f"{name} {ms:.4f} ms (runs {', '.join(f'{t:.4f}' for t in ts)})"
                                  for name, (ms, ts) in dev_ms.items())
            print(f"{what}, {launches // 2} launches a step: device {runs_text}, SDPA float32 "
                  f"backward {sdpa:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} GFLOP at 3xTF32; current at {bound / dev_ms['current'][0]:.3f} "
                  f"of the bound)", flush=True)
            for name, ms in [*((name, ms) for name, (ms, _) in dev_ms.items()),
                             ("SDPA backward", sdpa), ("bound", bound)]:
                totals[name] = totals.get(name, 0.0) + ms * launches / 2
            del qkv, do, bias, mask, dqkv, dbias, scratch
            torch.cuda.empty_cache()
    print("a float32 Swin-L train step's 24 launches (median x launches, ms): "
          + ", ".join(f"{name} {ms:.4f}" for name, ms in totals.items()), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", type=Path,
                        help="the earlier build's window_attention.cu (with --f32: attention_f32.cu)")
    parser.add_argument("--timing-only", action="store_true",
                        help="time an earlier build that is not meant to be right: print its "
                             "errors, do not fail")
    parser.add_argument("--forward", action="store_true",
                        help="A/B the forward instead of the backward")
    parser.add_argument("--f32", action="store_true",
                        help="A/B the float32 backward body of attention_f32.cu")
    parser.add_argument("--variant", action="append", default=[],
                        help="with --f32: NAME=PATH[:MACRO,...], another attention_f32.cu "
                             "timed in the same turns (NAME ending in '!': timing only)")
    parser.add_argument("--chunks", type=int, default=0,
                        help="chunks per head for the current build (default: its plan)")
    parser.add_argument("--windows", default="",
                        help="comma-separated window counts (bn) of the stages to run "
                             "(default: all four; the step's sums then cover only these)")
    args = parser.parse_args()
    only = {int(x) for x in args.windows.split(",") if x}
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    if args.f32:
        torch.backends.cuda.matmul.allow_tf32 = False
        sources = {"earlier": (args.earlier.resolve(), ()),
                   "current": (_build.CSRC / "attention_f32.cu", ())}
        for spec in args.variant:
            name, path = spec.split("=", 1)
            path, _, macros = path.partition(":")
            sources[name] = (Path(path).resolve(), tuple(m for m in macros.split(",") if m))
        with ThreadPoolExecutor(len(sources)) as pool:  # nvcc runs in parallel
            built = {name: pool.submit(load_f32, name, src, macros)
                     for name, (src, macros) in sources.items()}
            libs = {name: job.result() for name, job in built.items()}
        dev = torch.device("cuda")
        run_f32(args, libs, only, dev, torch.Generator(device=dev).manual_seed(0))
        return 0
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "window_attention.cu")}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if args.forward:
        run_forward(args, libs, only, dev, g)
        return 0
    stream = torch.cuda.current_stream().cuda_stream
    names = ("earlier", "current", "SDPA backward", "bound")
    totals = dict.fromkeys(names, 0.0)
    for (bn, c, heads, nw), launches in STAGES.items():
        if only and bn not in only:
            continue
        for with_mask in (True, False):
            d = c // heads
            qkv, bias, mask = inputs(g, bn, c, heads, nw, with_mask, dev)
            do = torch.randn((bn, N, c), generator=g, device=dev).bfloat16()
            dqkv = torch.empty_like(qkv)
            dbias = torch.empty((heads, N, N), device=dev)
            plans = {"earlier": plan(libs["earlier"], bn, heads, dev),
                     "current": plan(libs["current"], bn, heads, dev, args.chunks)}
            scratch = {name: torch.empty((ch if ch > 1 else 0, heads, N, N), device=dev)
                       for name, (ch, _) in plans.items()}

            def call(name):
                chunks, per = plans[name]
                checked(libs[name].dg_window_attention_packed_bwd_bf16(
                    qkv.data_ptr(), do.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
                    dbias.data_ptr(), scratch[name].data_ptr(), bn, N, heads,
                    nw if mask is not None else 1, chunks, per, d ** -0.5, stream))

            what = (f"bn={bn} C={c} H={heads} n={N} mask={'nW ' + str(nw) if with_mask else 'none'}")
            ref_dqkv, ref_dbias = wa.reference_window_attention_packed_backward(
                qkv, bias, mask, heads, do)  # the bf16 roundings of p and ds included
            ref_dqkv = ref_dqkv.float()
            for name in ("earlier", "current"):
                call(name)
                got = (dqkv.clone(), dbias.clone())
                call(name)
                same = torch.equal(got[0], dqkv) and torch.equal(got[1], dbias)
                parts = [(f"d{s}", got[0][..., i * c:(i + 1) * c], ref_dqkv[..., i * c:(i + 1) * c])
                         for i, s in enumerate("qkv")] + [("dbias", got[1], ref_dbias)]
                held(f"{what} (chunks {plans[name][0]} x {plans[name][1]} windows)", name, parts,
                     same, args.timing_only)
            del ref_dqkv, ref_dbias, got
            runs = {name: (lambda name=name: call(name)) for name in ("earlier", "current")}
            dev_ms = in_turns(runs)

            # the PyTorch call: the backward of SDPA alone, its inputs and forward built here
            q4, k4, v4 = (qkv[..., i * c:(i + 1) * c].reshape(bn, N, heads, d).transpose(1, 2)
                          .contiguous().requires_grad_(True) for i in range(3))
            dense = bias[None].expand(bn, -1, -1, -1)
            if mask is not None:
                dense = dense + mask.repeat(bn // nw, 1, 1)[:, None]
            dense = dense.bfloat16().contiguous()
            do4 = do.reshape(bn, N, heads, d).transpose(1, 2).contiguous()
            out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=dense)
            sdpa = device_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                         retain_graph=True))
            del q4, k4, v4, dense, do4, out4
            ops = 5 * 2.0 * bn * heads * N * N * d
            nbytes = (2.0 * bn * N * (3 * c + c + 3 * c) + 2 * 4.0 * heads * N * N
                      + (4.0 * nw * N * N if with_mask else 0.0))
            bound = 1e3 * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
            runs_text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
            print(f"{what}, {launches // 2} launches a step: device earlier "
                  f"{dev_ms['earlier'][0]:.4f} ms (runs {runs_text['earlier']}), current "
                  f"{dev_ms['current'][0]:.4f} ms (runs {runs_text['current']}), SDPA backward "
                  f"{sdpa:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.1f} GFLOP; current at "
                  f"{nbytes / dev_ms['current'][0] / 1e6:.0f} GB/s)", flush=True)
            for name, ms in (("earlier", dev_ms["earlier"][0]), ("current", dev_ms["current"][0]),
                             ("SDPA backward", sdpa), ("bound", bound)):
                totals[name] += ms * launches / 2
            del qkv, do, bias, mask, dqkv, dbias, scratch
            torch.cuda.empty_cache()
    print("a train step's 24 launches (median x launches, ms): "
          + ", ".join(f"{name} {ms:.4f}" for name, ms in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
