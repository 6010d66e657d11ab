"""Fused LayerNorm + GEMM: hand-written CUDA kernel on the card, plain torch
on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/ln_matmul.py:fused_ln_matmul``:
``LN(x) @ w (+ bias)`` with the epilogue none, exact-erf GELU (``act="gelu"``)
or GEGLU (``geglu=True``: ``h · gelu(gate)`` over the two halves of the
output columns, writing (M, N/2)). For a CUDA tensor it launches
``csrc/ln_matmul.cu``; for a CPU tensor it runs :func:`ln_matmul_reference`,
the plain version (``_reference`` of the TPU file). A CUDA tensor the kernel
cannot take raises. Kernel launches are counted in
``fused_ln_matmul.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_EPILOGUES = {"none": 0, "gelu": 1}
_GEGLU = 2


def ln_matmul_reference(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-5,
                        bias: Optional[torch.Tensor] = None, geglu: bool = False,
                        act: str = "none") -> torch.Tensor:
    """Row LayerNorm with var = E[x²] − E[x]² clamped at 0, normalized rows
    rounded to x's dtype, then the product in f32 and the epilogue."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)
    y = (y * gamma.float() + beta.float()).to(x.dtype)
    out = y.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    if geglu:
        h, gate = out.chunk(2, dim=-1)
        out = h * F.gelu(gate)
    elif act == "gelu":
        out = F.gelu(out)
    return out.to(x.dtype)


def fused_ln_matmul(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float = 1e-5,
                    bias: Optional[torch.Tensor] = None, geglu: bool = False,
                    act: str = "none") -> torch.Tensor:
    """LayerNorm(x) @ w (+ bias) [+ GELU or GEGLU epilogue].

    x (M, K), w (K, N), gamma/beta (K,), bias (N,). The kernel reads the
    weight as w.T, (N, K) row-major, which is nn.Linear's layout: passing
    ``linear.weight.t()`` costs no copy; any other layout of w is transposed
    into that one first."""
    if act not in _EPILOGUES:
        raise ValueError(f"act {act!r} not in {tuple(_EPILOGUES)}")
    if x.device.type == "cpu":
        return ln_matmul_reference(x, w, gamma, beta, eps, bias, geglu, act)
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    n = w.shape[1]
    cols = n // 2 if geglu else n
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}: the kernel needs CUDA")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16 x and w, got {x.dtype}, {w.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned x")
    if k % 8 or n % 8 or (geglu and n % 16):
        raise ValueError(f"K={k}, N={n}: the kernel needs K and the output width "
                         "to be multiples of 8")
    if m == 0:
        raise ValueError("empty input")
    wt = w.t().contiguous()  # a view of nn.Linear's weight: no copy
    if wt.data_ptr() % 16:
        raise ValueError("the kernel needs a 16-byte aligned weight")
    f32 = dict(device=x.device, dtype=torch.float32)
    gamma = gamma.to(**f32).contiguous()
    beta = beta.to(**f32).contiguous()
    if bias is not None:
        bias = bias.to(**f32).contiguous()
    stats = torch.empty((m, 2), **f32)
    out = torch.empty((m, cols), device=x.device, dtype=x.dtype)
    epilogue = _GEGLU if geglu else _EPILOGUES[act]
    lib = _build.lib()
    fused_ln_matmul.launches += 1
    code = lib.dg_ln_matmul_bf16(
        x.data_ptr(), wt.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if bias is None else bias.data_ptr(), stats.data_ptr(),
        out.data_ptr(), m, n, k, eps, epilogue,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(code, "fused LayerNorm-matmul kernel launch")
    return out


fused_ln_matmul.launches = 0
