#!/usr/bin/env python3
"""The float32 bodies on one GPU, quickly: builds the port's kernels, prints
the compiler's register and spill lines for ``attention_f32.cu`` and
``ln_matmul.cu``, holds the float32 attention body's tile plan
(``dg_attention_f32_plan``) against ``ops/attention_f32.py:TC_PLANS``, then
runs every float32 case through the port's wrappers, small and full-width
(kernels 1, 3, 4, the window forward in both layouts, kernel 2), each held
against its float32 twin at ``chip_smoke.F32_BOUNDS`` and run twice for the
same bits, with its device time (``chip_smoke.device_ms``) beside the
PyTorch float32 call's (TF32 off) and the 3xTF32 bound. Exits 1 if any case
fails. About 45 s of command on an H100:

    python3 tools/f32_check.py
"""
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import F32_BOUNDS, PEAK_F32_TC_FLOPS, card_line, compare, device_ms  # noqa: E402
from divergen_tpu_torch.ops import _build  # noqa: E402
from divergen_tpu_torch.ops import attention_f32 as af  # noqa: E402
from divergen_tpu_torch.ops import flash_attention as fa  # noqa: E402
from divergen_tpu_torch.ops import ln_matmul as lm  # noqa: E402
from divergen_tpu_torch.ops import window_attention as wa  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(card_line(), flush=True)
t0 = time.time()
so = _build.build()
print(f"build {time.time() - t0:.1f} s", flush=True)
sec = None
for line in so.with_suffix(".log").read_text().splitlines():
    if line.startswith("== "):
        sec = line
        continue
    if sec and ("attention_f32" in sec or "ln_matmul" in sec) and (
            "registers" in line or "spill" in line or "entry function" in line
            or "error" in line.lower() or "warning" in line.lower()):
        print(sec[3:], line.strip()[:200], flush=True)
lib = _build.lib()
for d in (32, 64, 80, 512):
    got = tuple(lib.dg_attention_f32_plan(d, f) for f in range(6))
    pl = af.TC_PLANS[d]
    want = (pl.rows, pl.keys, pl.warps_r, pl.warps_c, pl.stages, pl.smem(d))
    print(f"plan d={d}: library {got}, python {want}", flush=True)
    assert got == want

dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
fails = []


def randn(*shape, scale=1.0):
    return torch.randn(shape, generator=g, device=dev) * scale


def case(name, run, plain, lib_fn=None, flop=0.0, timing=True):
    try:
        got = run()
        torch.cuda.synchronize()
        ref = plain()
        compare(name, got, ref, **F32_BOUNDS)
        again = run()
        print(f"    same bits: {torch.equal(got, again)}", flush=True)
        if not torch.equal(got, again):
            fails.append(name + " bits")
        del ref, again
        if timing:
            k_ms = device_ms(run, reps=3)
            l_ms = device_ms(lib_fn, reps=3) if lib_fn else float("nan")
            print(f"    device kernel {k_ms:.4f} ms ({flop / k_ms / 1e9:.1f} TFLOP/s), PyTorch f32 "
                  f"{l_ms:.4f} ms, bound (3xTF32) {1e3 * flop / PEAK_F32_TC_FLOPS:.4f} ms", flush=True)
    except (AssertionError, RuntimeError) as e:
        print(f"  {name}: FAILED {type(e).__name__}: {str(e)[:300]}", flush=True)
        fails.append(name)
    torch.cuda.empty_cache()


def heads_first(t, heads):
    return t.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()


# kernel 1: packed
for b, n, c, heads in ((2, 256, 128, 2), (1, 1000, 640, 10), (4, 4096, 640, 10)):
    qkv = randn(b, n, 3 * c)
    q4, k4, v4 = (heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
    case(f"packed {b, n, c, heads}", lambda: fa.flash_attention_packed(qkv, heads),
         lambda: fa.reference_attention_packed(qkv, heads),
         lambda: F.scaled_dot_product_attention(q4, k4, v4), 4.0 * b * n * n * c)
# kernel 3
for bh, sq, sk, d, with_bias in ((1, 1024, 1024, 512, True), (2, 1000, 777, 512, False),
                                 (2, 1000, 777, 64, True), (1, 4096, 4096, 512, False),
                                 (1, 16384, 16384, 512, False)):
    q, k, v = randn(bh, sq, d), randn(bh, sk, d), randn(bh, sk, d)
    bias = randn(bh, sq, sk) if with_bias else None
    case(f"flash {bh, sq, sk, d} bias={with_bias}", lambda: fa.flash_attention(q, k, v, bias),
         lambda: fa.reference_attention(q, k, v, bias),
         lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=bias),
         4.0 * bh * sq * sk * d)
    del q, k, v, bias
# kernel 4
for b, heads, h, w in ((2, 16, 16, 16), (1, 2, 14, 10), (4, 16, 64, 64)):
    d = 80
    n = h * w
    fused = randn(b, n, 3, heads, d)
    q, k, v = (fused[:, :, s].permute(0, 2, 1, 3) for s in range(3))
    bh_t, bw_t = randn(b * heads, h, n, scale=0.7), randn(b * heads, w, n, scale=0.7)
    dense = fa.relpos_dense_bias(bh_t, bw_t).contiguous().reshape(b, heads, n, n)
    case(f"relpos {b, heads, h, w}",
         lambda: fa.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w)).reshape(b * heads, n, d),
         lambda: fa.reference_attention_relpos(*(t.reshape(b * heads, n, d) for t in (q, k, v)),
                                               bh_t, bw_t, (h, w)),
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense), 4.0 * b * heads * n * n * d)
    del fused, dense
# kernels 5/6 forward
for bn, heads, nw, n in ((8, 6, 4, 144), (722, 6, 361, 144), (6, 3, 2, 49)):
    c = 32 * heads
    qkv = randn(bn, n, 3 * c)
    bias = randn(heads, n, n, scale=0.5)
    mask = torch.where(torch.rand((nw, n, n), generator=g, device=dev) < 0.3, -100.0, 0.0)
    mask.diagonal(dim1=1, dim2=2).zero_()
    win_mask = (bias[None] + mask.repeat(bn // nw, 1, 1)[:, None]).contiguous()
    q4, k4, v4 = (heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
    case(f"window packed {bn, heads, nw, n}",
         lambda: wa.fused_window_attention_packed(qkv, bias, mask, heads),
         lambda: wa.reference_window_attention_packed(qkv, bias, mask, heads),
         lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask), 4.0 * bn * n * n * c)
    q, k, v = qkv.reshape(bn, n, 3, heads, 32).permute(2, 0, 3, 1, 4)
    case(f"window split {bn, heads, nw, n}",
         lambda: wa.fused_window_attention(q, k, v, bias, mask),
         lambda: wa.reference_window_attention(q, k, v, bias, mask), timing=False)
# kernel 2
for m, k, n, geglu, act, with_bias, eps in (
        (1000, 640, 3840, False, "none", True, 1e-5), (1000, 640, 3840, True, "none", True, 1e-5),
        (1000, 1280, 5120, False, "gelu", True, 1e-6), (200, 2560, 336, True, "none", True, 1e-5),
        (4096, 1280, 10240, True, "none", False, 1e-5), (16384, 640, 5120, True, "none", False, 1e-5),
        (16384, 1280, 3840, False, "none", True, 1e-6), (16384, 1280, 5120, False, "gelu", True, 1e-6)):
    x = randn(m, k, scale=2.0)
    w = randn(n, k, scale=k ** -0.5).t()
    gamma = 1.0 + 0.1 * randn(k)
    beta = 0.1 * randn(k)
    bias = 0.1 * randn(n) if with_bias else None

    def library():
        y = F.linear(F.layer_norm(x, (k,), gamma, beta, eps), w.t(), bias)
        if geglu:
            hh, gate = y.chunk(2, dim=-1)
            return hh * F.gelu(gate)
        return F.gelu(y) if act == "gelu" else y

    case(f"ln_matmul {m, k, n} geglu={geglu} {act}",
         lambda: lm.fused_ln_matmul(x, w, gamma, beta, eps, bias, geglu, act),
         lambda: lm.ln_matmul_reference(x, w, gamma, beta, eps, bias, geglu, act), library,
         2.0 * m * k * n)
    del x, w
print("FAILS:", fails, flush=True)
sys.exit(1 if fails else 0)
