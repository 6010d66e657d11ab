#!/usr/bin/env python3
"""A/B of the int8 GEMM kernels (kernels 10 and 11) against an earlier build,
at every int8 GEMM shape of an SDXL UNet call, on one GPU.

Runs from the root of a checkout. Extract the earlier sources first (the
machine that runs this needs no git), e.g. for the parent commit:

    mkdir -p build/scratch/old
    git show HEAD~1:divergen_tpu_torch/csrc/int8_matmul.cu > build/scratch/old/int8_matmul.cu
    git show HEAD~1:divergen_tpu_torch/csrc/mma_sm90.cuh > build/scratch/old/mma_sm90.cuh
    python3 tools/int8_gemm_ab.py build/scratch/old/int8_matmul.cu [--bn WIDTH]

Builds that source and the checkout's ``csrc/int8_matmul.cu`` with nvcc, each
into a library of its own under ``build/scratch/`` (headers from the source's
own directory first, then ``csrc/``), and calls their C entry points on the
same operands. An earlier build has either the current interface
(``dg_int8_quantize_rows`` then ``dg_int8_matmul`` for kernel 11, with the
tile plan of ``ops/int8_matmul.py:gemm_plan``) or that of the mma.sync body
the wgmma one replaced (``dg_int8_matmul_fused_quant`` and a four-int
``dg_int8_matmul``, one launch each). ``--bn`` gives the current build's
tile width at every shape instead of the plan's.

For each shape of ``ops/int8_matmul.py:UNET_INT8_GEMMS`` (bf16 x and output,
seeded operands) it checks that both builds equal the plain version in every
element, then times them in turns (earlier, current, current, earlier, three
times) by device time under ``torch.profiler`` (``chip_smoke.device_ms``: 10
calls a timing; medians of 6 timings each), beside ``torch._int_mm`` on the
same int8 operands, and by host time per call (``host_us``: what the C entry
point takes to encode its arguments and enqueue its launches; medians of 6).
Where both builds have the row-quantize pass, its device time alone is timed
in turns too, once per (M, K). Prints each shape and, per kernel, the sums of
median x launches per UNet call. Needs a CUDA device; prints the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path

import torch

from ab_common import build, checked, in_turns
from chip_smoke import card_line, device_ms
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import int8_matmul as i8
from divergen_tpu_torch.ops.quant import quantize_act, quantize_weight


def load(name: str, src: Path) -> ctypes.CDLL:
    lib = build("int8_ab", name, src)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_sync = hasattr(lib, "dg_int8_matmul_fused_quant")
    if lib.mma_sync:
        lib.dg_int8_matmul.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.dg_int8_matmul_fused_quant.argtypes = [p] * 4 + [i] * 5 + [p]
    else:
        lib.dg_int8_matmul.argtypes = [p] * 5 + [i] * 6 + [p]
        lib.dg_int8_quantize_rows.argtypes = [p] * 3 + [i] * 3 + [p]
    return lib


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call in us: ``calls`` calls back to back, timed
    before the device has finished them (launches queue asynchronously)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", type=Path, help="the earlier build's int8_matmul.cu")
    parser.add_argument("--bn", type=int, choices=i8.GEMM_BNS,
                        help="the current build's tile width at every shape")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}", flush=True)
    libs = {"earlier": load("earlier", args.earlier.resolve()),
            "current": load("current", _build.CSRC / "int8_matmul.cu")}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    totals = {}
    passes_timed = set()
    for kernel, shapes in i8.UNET_INT8_GEMMS.items():
        fused = kernel == "int8_matmul_fused_quant"
        for (m, k, n), launches in shapes.items():
            x = torch.randn((m, k), generator=g, device=dev).bfloat16()
            w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
            w_q, w_s = quantize_weight(w.t())
            wt = w_q.t().contiguous()  # (N, K), the operand both builds read
            x_q, x_s = quantize_act(x)
            xs = x_s.reshape(m).contiguous()
            scratch_q = torch.empty((m, k), device=dev, dtype=torch.int8)
            scratch_s = torch.empty((m,), device=dev, dtype=torch.float32)
            out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
            ref = (i8.int8_matmul_fused_quant_reference(x, wt.t(), w_s) if fused
                   else i8.int8_matmul_pallas_reference(x_q, x_s, wt.t(), w_s))
            plan = {name: i8.gemm_plan(m, n, sms) for name in libs}
            if args.bn:
                plan["current"] = (args.bn, min(-(-m // i8.GEMM_BM) * -(-n // args.bn), sms))

            def row_pass(lib):
                checked(lib.dg_int8_quantize_rows(x.data_ptr(), scratch_q.data_ptr(),
                                                  scratch_s.data_ptr(), m, k, 0, stream))

            def call(lib, bn, ctas):
                if lib.mma_sync:
                    if fused:
                        return lib.dg_int8_matmul_fused_quant(
                            x.data_ptr(), wt.data_ptr(), w_s.data_ptr(), out.data_ptr(), m, n, k,
                            0, 0, stream)
                    return lib.dg_int8_matmul(x_q.data_ptr(), xs.data_ptr(), wt.data_ptr(),
                                              w_s.data_ptr(), out.data_ptr(), m, n, k, 0, stream)
                a_q, a_s = x_q, xs
                if fused:
                    row_pass(lib)
                    a_q, a_s = scratch_q, scratch_s
                return lib.dg_int8_matmul(a_q.data_ptr(), a_s.data_ptr(), wt.data_ptr(),
                                          w_s.data_ptr(), out.data_ptr(), m, n, k, 0, bn, ctas,
                                          stream)

            runs = {}
            for name, lib in libs.items():
                runs[name] = lambda lib=lib, name=name: checked(call(lib, *plan[name]))
                out.zero_()
                runs[name]()
                torch.cuda.synchronize()
                differ = int((out != ref).sum())
                if differ:
                    raise AssertionError(f"{name} build, {kernel} {(m, k, n)}: {differ} "
                                         "elements differ from the plain version")
            dev_ms = in_turns(runs, device_ms)
            host = in_turns(runs, host_us)
            int_mm = device_ms(lambda: torch._int_mm(x_q, wt.t()))
            sums = totals.setdefault(kernel, {})
            for name, (ms, _) in dev_ms.items():
                sums[f"{name} device ms"] = sums.get(f"{name} device ms", 0.0) + ms * launches
                sums[f"{name} host ms"] = (sums.get(f"{name} host ms", 0.0)
                                           + host[name][0] * launches / 1e3)
            sums["torch._int_mm device ms"] = (sums.get("torch._int_mm device ms", 0.0)
                                               + int_mm * launches)
            text = {name: ", ".join(f"{t:.4f}" for t in ts) for name, (_, ts) in dev_ms.items()}
            print(f"{kernel} (M, K, N) = {(m, k, n)}, {launches} launches per UNet call: "
                  f"device earlier {dev_ms['earlier'][0]:.4f} ms (runs {text['earlier']}), "
                  f"current {dev_ms['current'][0]:.4f} ms (runs {text['current']}), "
                  f"torch._int_mm {int_mm:.4f} ms; host per call earlier "
                  f"{host['earlier'][0]:.2f} us, current {host['current'][0]:.2f} us; tiles "
                  + ", ".join(f"{name} {bn} wide on {ctas} blocks"
                              for name, (bn, ctas) in plan.items() if not libs[name].mma_sync)
                  + "; 0 elements differ in both builds", flush=True)
            if fused and (m, k) not in passes_timed and not any(l.mma_sync for l in libs.values()):
                passes_timed.add((m, k))
                want_q, want_s = i8.quantize_rows_fq_reference(x)
                for name, lib in libs.items():
                    row_pass(lib)
                    if not (torch.equal(scratch_q, want_q)
                            and torch.equal(scratch_s, want_s.reshape(m))):
                        raise AssertionError(f"{name} build: the row pass at {(m, k)} differs "
                                             "from quantize_rows_fq_reference")
                pass_ms = in_turns({name: (lambda lib=lib: row_pass(lib))
                                    for name, lib in libs.items()}, device_ms)
                print(f"  row pass (M, K) = {(m, k)}: earlier {pass_ms['earlier'][0]:.4f} ms "
                      f"(runs {', '.join(f'{t:.4f}' for t in pass_ms['earlier'][1])}), current "
                      f"{pass_ms['current'][0]:.4f} ms "
                      f"(runs {', '.join(f'{t:.4f}' for t in pass_ms['current'][1])}); "
                      "both equal the plain version", flush=True)
                del want_q, want_s
            del x, w, w_q, wt, x_q, x_s, xs, scratch_q, scratch_s, out, ref
            torch.cuda.empty_cache()
    for kernel, sums in totals.items():
        print(f"{kernel}: per UNet call (median x launches): "
              + ", ".join(f"{name} {ms:.3f}" for name, ms in sums.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
