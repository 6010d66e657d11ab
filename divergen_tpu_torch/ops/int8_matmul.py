"""W8A8 GEMM with the dequantization fused into its epilogue: hand-written
CUDA kernels on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/int8_matmul.py``:

* :func:`int8_matmul_pallas` (x already quantized: int8 (M, K) and a per-row
  f32 scale) → ``dg_int8_matmul``;
* :func:`int8_matmul_fused_quant` (bf16 or f32 x, quantized per row in the
  kernel with the TPU kernel's own scale ``max(absmax, 1e-12) / 127``, which
  differs from ``quant.quantize_act``'s ``max(absmax / 127, 1e-12)`` for rows
  whose absmax is below 1.27e-10) → ``dg_int8_matmul_fused_quant``.

Both compute ``(float(x_q @ w_q) * x_scale) * w_scale`` with exact int32 sums
and write ``out_dtype``; both launch ``csrc/int8_matmul.cu`` for a CUDA tensor
(bf16 or f32 output, K a multiple of 16, any M and N) and run the plain
versions in this module for a CPU tensor. A CUDA tensor the kernels cannot take raises.
Launches are counted in ``int8_matmul_pallas.launches`` and
``int8_matmul_fused_quant.launches``.

``supported`` and ``supported_fused_quant`` are the JAX file's tiling
predicates with its block candidates: ``ops/quant.py:int8_matmul`` dispatches
on them exactly as the JAX function does on its accelerator.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import _build

_BLOCKS = (1024, 640, 512, 256, 128)
_FQ_M_BLOCKS = (512, 256, 128)
_FQ_N_BLOCKS = (1024, 640, 512, 256, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # what the kernels read as x and write


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
    tensor on the same device is divided exactly, as the JAX formulas and the
    kernels divide.)"""
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


def int8_matmul_fused_quant_reference(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K) float, quantized per row with scale max(absmax, 1e-12) / 127,
    then as :func:`int8_matmul_pallas_reference`."""
    xf = x.float()
    scale = per_127(xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12))
    x_q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return (_int_product(x_q, w_q) * scale * w_scale.float()).to(out_dtype)


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
    wt = _check_cuda("int8_matmul_pallas", m, k, w_q, w_scale, out_dtype, x_q.device)
    if x_q.dtype != torch.int8 or not x_q.is_contiguous() or x_q.data_ptr() % 16:
        raise ValueError("int8_matmul_pallas: the kernel takes a contiguous, 16-byte aligned "
                         f"int8 x_q, got {x_q.dtype}")
    xs = x_scale.reshape(m)
    if xs.dtype != torch.float32 or xs.device != x_q.device or not xs.is_contiguous():
        raise ValueError("int8_matmul_pallas: x_scale must be a contiguous float32 (M, 1) "
                         "on the kernel's device")
    n = wt.shape[0]
    out = torch.empty((m, n), device=x_q.device, dtype=out_dtype)
    lib = _build.lib()
    int8_matmul_pallas.launches += 1
    code = lib.dg_int8_matmul(
        x_q.data_ptr(), xs.data_ptr(), wt.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, n, k, int(out_dtype == torch.float32),
        torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check(code, "int8 matmul kernel launch")
    return out


def int8_matmul_fused_quant(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M, K) float, w_q (K, N) int8, w_scale (N,) f32 → (M, N), with the
    per-row activation quantization inside the kernel (bf16 or f32 x on the
    card)."""
    m, k = x.shape
    if w_q.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} do not chain")
    if x.device.type == "cpu":
        return int8_matmul_fused_quant_reference(x, w_q, w_scale, out_dtype)
    wt = _check_cuda("int8_matmul_fused_quant", m, k, w_q, w_scale, out_dtype, x.device)
    if x.dtype not in KERNEL_DTYPES or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("int8_matmul_fused_quant: the kernel takes a contiguous, 16-byte "
                         f"aligned bfloat16 or float32 x, got {x.dtype}")
    n = wt.shape[0]
    out = torch.empty((m, n), device=x.device, dtype=out_dtype)
    lib = _build.lib()
    int8_matmul_fused_quant.launches += 1
    code = lib.dg_int8_matmul_fused_quant(
        x.data_ptr(), wt.data_ptr(), w_scale.data_ptr(), out.data_ptr(), m, n, k,
        int(x.dtype == torch.float32), int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "int8 fused-quant matmul kernel launch")
    return out


int8_matmul_pallas.launches = 0
int8_matmul_fused_quant.launches = 0
