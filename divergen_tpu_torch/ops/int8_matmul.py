"""W8A8 GEMM with the dequantization fused into its epilogue: hand-written
CUDA kernels on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/int8_matmul.py``:

* :func:`int8_matmul_pallas` (x already quantized: int8 (M, K) and a per-row
  f32 scale) → ``dg_int8_matmul``, one launch;
* :func:`int8_matmul_fused_quant` (bf16 or f32 x, quantized per row with the
  TPU kernel's own scale ``max(absmax, 1e-12) / 127``, which differs from
  ``quant.quantize_act``'s ``max(absmax / 127, 1e-12)`` for rows whose absmax
  is below 1.27e-10) → ``dg_int8_quantize_rows`` (each row quantized once
  into int8 and f32 scratch) then the same ``dg_int8_matmul``: two launches
  behind one wrapper call.

Both compute ``(float(x_q @ w_q) * x_scale) * w_scale`` with exact int32 sums
and write ``out_dtype``; both launch ``csrc/int8_matmul.cu`` for a CUDA tensor
(bf16 or f32 output, K a multiple of 16, any M and N) and run the plain
versions in this module for a CPU tensor. A CUDA tensor the kernels cannot take raises.
Launches are counted in ``int8_matmul_pallas.launches`` and
``int8_matmul_fused_quant.launches`` (one per wrapper call). Both are forward
only, as the JAX kernels (no ``custom_vjp``): on a CUDA tensor they raise
where autograd would record them (``_build.require_no_grad``).

The GEMM is persistent: :func:`gemm_plan` picks its tile width and its
number of blocks from the output's shape and the card's SM count.

``supported`` and ``supported_fused_quant`` are the JAX file's tiling
predicates with its block candidates: ``ops/quant.py:int8_matmul`` dispatches
on them exactly as the JAX function does on its accelerator.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from . import _build

_BLOCKS = (1024, 640, 512, 256, 128)
_FQ_M_BLOCKS = (512, 256, 128)
_FQ_N_BLOCKS = (1024, 640, 512, 256, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # what the kernels read as x and write
GEMM_BM = 128  # output rows per tile of the GEMM kernel
GEMM_BNS = (160, 128)  # the tile widths it is built for, widest first

# The int8 GEMMs of one UNetSDXL(quant) call at B = 2, 1024² (UNet batch 4):
# (M, K, N) -> launches, by the kernel that takes them (ops/quant.py's
# dispatch): 382 and 130 a call. Level 1 (16384 rows, C 640, 10 blocks, 5
# transformers): qkv, the C -> C GEMMs (attn1_out, attn2_q, attn2_out per
# block, proj_in/out per transformer), ff_geglu, ff_out and attn2_kv (M = 4 x
# 77); level 2 (4096 rows, C 1280, 60 blocks, 6 transformers) the same, its
# ff_out (K 5120) on int8_matmul_pallas. The shapes the tile plan is judged on.
UNET_INT8_GEMMS = {
    "int8_matmul_fused_quant": {(16384, 640, 1920): 10, (16384, 640, 640): 40,
                                (16384, 640, 5120): 10, (16384, 2560, 640): 10,
                                (4096, 1280, 3840): 60, (4096, 1280, 1280): 192,
                                (4096, 1280, 10240): 60},
    "int8_matmul_pallas": {(4096, 5120, 1280): 60, (308, 2048, 1280): 10,
                           (308, 2048, 2560): 60},
}


def _pick_block(dim: int, candidates: Sequence[int] = _BLOCKS) -> int:
    for c in candidates:
        if dim % c == 0:
            return c
    return 0


def supported(m: int, k: int, n: int) -> bool:
    """Shapes the JAX package's ``int8_matmul_pallas`` tiles."""
    return bool(_pick_block(m) and _pick_block(k) and _pick_block(n))


def supported_fused_quant(m: int, k: int, n: int) -> bool:
    """Shapes the JAX package's ``int8_matmul_fused_quant`` tiles: the whole K
    extent in one block, K ≤ 4096."""
    return (bool(_pick_block(m, _FQ_M_BLOCKS) and _pick_block(n, _FQ_N_BLOCKS))
            and k % 128 == 0 and k <= 4096)


def per_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division on every device. (On a CUDA tensor
    torch divides by a Python scalar as a multiplication by its reciprocal,
    which is off by one unit in the last place for some values; a divisor
    tensor on the same device is divided exactly, as the JAX formulas are
    written and the kernels divide. XLA's CPU compiler, and so the JAX
    package's CPU path and its Pallas kernels in interpret mode, rewrites the
    formulas' ``/ 127.0`` into the same reciprocal product:
    ``tests/test_torch_int8_rows.py`` holds that difference to one unit in
    the last place of a scale.)"""
    return t / t.new_full((), 127.0)


def _int_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int8 × int8 sums as float32 (each rounded once, as an int32
    → f32 cast rounds). float64 holds every partial sum exactly (|sum| ≤
    127² · K < 2⁵³), and runs on the CPU and the card alike."""
    return (x_q.double() @ w_q.double()).float()


def int8_matmul_pallas_reference(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                                 w_scale: torch.Tensor,
                                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_q (M, K) int8, x_scale (M, 1) f32, w_q (K, N) int8, w_scale (N,) f32
    → (float(x_q @ w_q) * x_scale) * w_scale in ``out_dtype``."""
    acc = _int_product(x_q, w_q)
    return (acc * x_scale.reshape(-1, 1).float() * w_scale.float()).to(out_dtype)


def quantize_rows_fq_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) float → (x_q int8 (M, K), x_scale f32 (M, 1)) with the fused
    kernel's row scale max(absmax, 1e-12) / 127 (a true division), round half
    to even and a clip to ±127: the plain twin of the row-quantize pass."""
    xf = x.float()
    scale = per_127(xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_matmul_fused_quant_reference(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K) float, quantized per row with scale max(absmax, 1e-12) / 127,
    then as :func:`int8_matmul_pallas_reference`."""
    x_q, scale = quantize_rows_fq_reference(x)
    return (_int_product(x_q, w_q) * scale * w_scale.float()).to(out_dtype)


def gemm_plan(m: int, n: int, sms: int) -> Tuple[int, int]:
    """(tile width BN, persistent blocks) of the GEMM kernel for an (M, N)
    output on a card of ``sms`` SMs.

    The output is cut into ``GEMM_BM`` × BN tiles, numbered with the row
    tiles fastest: tile t covers rows ``(t % tiles_m) · GEMM_BM`` and columns
    ``(t // tiles_m) · BN`` on. Block b takes tiles b, b + blocks, …, so the
    busiest block takes ceil(tiles / blocks) of them. BN is the width in
    ``GEMM_BNS`` that minimises that count times BN, the widest on a tie: on
    an H100 a tile's time grows with its width and has no fixed part that
    shows (at M 308, K 2048, one tile a block, 160 wide takes 1.26x as long
    as 128), and where the two cost the same, 160 was 1-2 % faster at every
    SDXL UNet shape measured (``tools/int8_gemm_ab.py --bn``). That picks the
    faster width at each shape of ``UNET_INT8_GEMMS``: 128 at M 308 and at
    (16384, 640, 5120), 160 elsewhere."""
    tiles_m = -(-m // GEMM_BM)
    best = None
    for bn in GEMM_BNS:
        tiles = tiles_m * -(-n // bn)
        cost = -(-tiles // sms) * bn
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    return bn, min(tiles, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(what: str, m: int, k: int, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Checks shared by both kernels; returns the (N, K) row-major weight."""
    if device.type != "cuda" or w_q.device != device or w_scale.device != device:
        raise ValueError(f"{what}: operands on {device}, {w_q.device}, {w_scale.device}; "
                         "the kernel needs them on one CUDA device")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError(f"{what}: the kernel takes int8 w_q and float32 w_scale, got "
                         f"{w_q.dtype}, {w_scale.dtype}")
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the kernel writes bfloat16 or float32, not {out_dtype}")
    if k % 16 or m == 0 or w_q.shape[1] == 0:
        raise ValueError(f"{what}: M={m}, K={k}, N={w_q.shape[1]}: the kernel needs K a "
                         "multiple of 16 and a non-empty product")
    if w_scale.shape != (w_q.shape[1],) or not w_scale.is_contiguous():
        raise ValueError(f"{what}: w_scale {tuple(w_scale.shape)} is not a contiguous (N,)")
    wt = w_q.t().contiguous()  # a view of an (N, K) buffer: no copy
    if wt.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel needs a 16-byte aligned weight")
    return wt


def _gemm(x_q: torch.Tensor, xs: torch.Tensor, wt: torch.Tensor, w_scale: torch.Tensor,
          out: torch.Tensor) -> torch.Tensor:
    """Launches the GEMM kernel on checked CUDA operands: x_q (M, K) int8, xs
    (M,) f32, wt (N, K) int8, w_scale (N,) f32, into out, a contiguous (M, N)
    bf16 or f32 tensor on their device."""
    (m, k), n = x_q.shape, wt.shape[0]
    bn, ctas = gemm_plan(m, n, _sm_count(x_q.device.index))
    code = _build.lib().dg_int8_matmul(
        x_q.data_ptr(), xs.data_ptr(), wt.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, n, k, int(out.dtype == torch.float32), bn, ctas,
        torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check(code, "int8 matmul kernel launch")
    return out


def _quantize_rows_fq(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-quantize pass of :func:`int8_matmul_fused_quant` on a checked
    CUDA x (M, K): (x_q int8 (M, K), x_scale f32 (M,)), as
    :func:`quantize_rows_fq_reference` computes them."""
    m, k = x.shape
    x_q = torch.empty((m, k), device=x.device, dtype=torch.int8)
    xs = torch.empty((m,), device=x.device, dtype=torch.float32)
    code = _build.lib().dg_int8_quantize_rows(
        x.data_ptr(), x_q.data_ptr(), xs.data_ptr(), m, k, int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "int8 row-quantize kernel launch")
    return x_q, xs


def int8_matmul_pallas(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_q (M, K) int8, x_scale (M, 1) f32, w_q (K, N) int8, w_scale (N,) f32
    → (M, N). The kernel reads the weight as w_q.T, (N, K) row-major: pass
    the transpose view of an (N, K) buffer and nothing is copied."""
    m, k = x_q.shape
    if w_q.shape[0] != k:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q {tuple(w_q.shape)} do not chain")
    if x_q.device.type == "cpu":
        return int8_matmul_pallas_reference(x_q, x_scale, w_q, w_scale, out_dtype)
    _build.require_no_grad("int8_matmul_pallas", x_q, x_scale, w_q, w_scale)
    wt = _check_cuda("int8_matmul_pallas", m, k, w_q, w_scale, out_dtype, x_q.device)
    if x_q.dtype != torch.int8 or not x_q.is_contiguous() or x_q.data_ptr() % 16:
        raise ValueError("int8_matmul_pallas: the kernel takes a contiguous, 16-byte aligned "
                         f"int8 x_q, got {x_q.dtype}")
    xs = x_scale.reshape(m)
    if xs.dtype != torch.float32 or xs.device != x_q.device or not xs.is_contiguous():
        raise ValueError("int8_matmul_pallas: x_scale must be a contiguous float32 (M, 1) "
                         "on the kernel's device")
    int8_matmul_pallas.launches += 1
    return _gemm(x_q, xs, wt, w_scale, x_q.new_empty((m, wt.shape[0]), dtype=out_dtype))


def int8_matmul_fused_quant(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K) float, w_q (K, N) int8, w_scale (N,) f32 → (M, N), x quantized
    per row as :func:`quantize_rows_fq_reference` does (bf16 or f32 x on the
    card: the row-quantize pass, then the GEMM)."""
    m, k = x.shape
    if w_q.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} do not chain")
    if x.device.type == "cpu":
        return int8_matmul_fused_quant_reference(x, w_q, w_scale, out_dtype)
    _build.require_no_grad("int8_matmul_fused_quant", x, w_q, w_scale)
    wt = _check_cuda("int8_matmul_fused_quant", m, k, w_q, w_scale, out_dtype, x.device)
    if x.dtype not in KERNEL_DTYPES or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("int8_matmul_fused_quant: the kernel takes a contiguous, 16-byte "
                         f"aligned bfloat16 or float32 x, got {x.dtype}")
    int8_matmul_fused_quant.launches += 1
    x_q, xs = _quantize_rows_fq(x)
    return _gemm(x_q, xs, wt, w_scale, x.new_empty((m, wt.shape[0]), dtype=out_dtype))


int8_matmul_pallas.launches = 0
int8_matmul_fused_quant.launches = 0
