"""NHWC GroupNorm (+ SiLU): hand-written CUDA kernel on the card, plain torch
on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/group_norm.py:fused_group_norm``:
per-channel f32 Σx and Σx² over (H, W), combined within each group into a
mean and ``rsqrt(max(E[x²] − mean², 0) + eps)`` (the kernel path's combine,
``group_norm.py:151-156``; the JAX file's ``_reference`` takes the mean of
per-channel means and does not clamp), then ``(x − mean) · rstd · scale +
bias`` and, with ``silu``, ``y · sigmoid(y)``, in x's dtype. For a CUDA
tensor it launches ``csrc/group_norm.cu`` (bf16 or f32, any C); for a CPU
tensor it runs :func:`group_norm_reference`. A CUDA tensor the kernel cannot take raises.
Launches (one per call, whatever passes the kernel makes) are counted in
``fused_group_norm.launches``.

The gradient recomputes through :func:`group_norm_reference`, as the JAX
``custom_vjp`` recomputes through its reference: there is no backward kernel.
"""
from __future__ import annotations

import math

import torch

from . import _build

SMS = 132  # H100 SXM: the moments pass aims at two blocks per SM


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """x (B, H, W, C); scale, bias (C,); ``groups`` divides C."""
    b, h, w, c = x.shape
    cpg = c // groups
    n = h * w * cpg
    xf = x.float()
    s1 = xf.sum(dim=(1, 2)).view(b, groups, cpg).sum(-1) / n
    s2 = (xf * xf).sum(dim=(1, 2)).view(b, groups, cpg).sum(-1) / n
    rstd = torch.rsqrt((s2 - s1 * s1).clamp_min(0.0) + eps)
    mean_c = s1.repeat_interleave(cpg, dim=-1)[:, None, None, :]
    rstd_c = rstd.repeat_interleave(cpg, dim=-1)[:, None, None, :]
    y = (xf - mean_c) * rstd_c
    y = y * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def moment_splits(batch: int, hw: int, c: int) -> int:
    """How many blocks share an image's positions in the moments pass: about
    two blocks per SM over the (channel tile, image) pairs, at least 64
    positions each. A function of the shapes only, so the order of every sum
    is fixed."""
    vec = 8 if c % 8 == 0 else 1
    tiles = -(-(c // vec) // 32)
    want = -(-2 * SMS // (batch * tiles))
    return max(1, min(want, hw // 64))


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
            silu: bool) -> torch.Tensor:
    b, h, w, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_group_norm: the kernel takes bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_group_norm: the kernel takes a contiguous, 16-byte aligned x")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError(f"fused_group_norm: x on {x.device}, scale on {scale.device}, "
                         f"bias on {bias.device}")
    if not 0 < groups <= 32 or c % groups or x.numel() == 0:
        raise ValueError(f"fused_group_norm: {groups} groups of C={c}, shape {tuple(x.shape)}")
    f32 = dict(device=x.device, dtype=torch.float32)
    scale = scale.to(**f32).contiguous()
    bias = bias.to(**f32).contiguous()
    splits = moment_splits(b, h * w, c)
    part = torch.empty((b, splits, 2, c), **f32)
    stats = torch.empty((b, groups, 2), **f32)
    out = torch.empty_like(x)
    lib = _build.lib()
    fused_group_norm.launches += 1
    code = lib.dg_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(), stats.data_ptr(),
        out.data_ptr(), b, h * w, c, groups, splits, eps, int(silu), int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "group norm kernel launch")
    return out


class _FusedGroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (groups, eps, silu)
        if x.device.type == "cpu":
            return group_norm_reference(x, scale, bias, groups, eps, silu)
        if x.device.type != "cuda":
            raise ValueError(f"fused_group_norm: x on {x.device}; the kernel needs CUDA")
        return _launch(x, scale, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, gout):
        x, scale, bias = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = group_norm_reference(x, scale, bias, *ctx.cfg)
        gx, gs, gb = torch.autograd.grad(y, (x, scale, bias), gout)
        return gx, gs, gb, None, None, None


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int = 32, eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """GroupNorm of NHWC x over (H, W, C / G) with G = gcd(groups, C), an
    optional SiLU epilogue; output in x's dtype."""
    g = math.gcd(groups, x.shape[-1])
    return _FusedGroupNorm.apply(x, scale, bias, g, eps, silu)


fused_group_norm.launches = 0
