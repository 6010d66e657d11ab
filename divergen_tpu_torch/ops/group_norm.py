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

The kernel makes two passes over one plan (:func:`norm_plan`, a function of
the shapes only): per-block partial sums of each group, then the apply pass,
whose blocks each combine their image's partials in the fixed order of
:func:`combine_slices` before they normalize. No atomics: two runs give the
same bits. ``UNET_GROUP_NORMS`` lists the calls one int8 + fused-norm UNet
call makes.

The gradient recomputes through :func:`group_norm_reference`, as the JAX
``custom_vjp`` recomputes through its reference: there is no backward kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


NORM_THREADS = 512  # threads of a block of either pass at most (``dg_group_norm_threads``)
NORM_BLOCKS_PER_SM = 2  # the passes' launch bounds
# (B, H, W, C, silu) -> fused_group_norm calls in one full-width
# UNetSDXL(quant, fused_ln, fused_gn) call at B = 2 images, 1024² (UNet batch 4,
# latents 128²): the two norms of each of the 17 ResBlocks (with SiLU), the
# 11 spatial transformers' input norms and norm_out (with SiLU)
UNET_GROUP_NORMS = {(4, 128, 128, 320, True): 8, (4, 128, 128, 640, True): 2,
                    (4, 128, 128, 960, True): 1, (4, 64, 64, 320, True): 1,
                    (4, 64, 64, 640, True): 6, (4, 64, 64, 960, True): 1,
                    (4, 64, 64, 1280, True): 1, (4, 64, 64, 1920, True): 1,
                    (4, 32, 32, 640, True): 1, (4, 32, 32, 1280, True): 10,
                    (4, 32, 32, 1920, True): 1, (4, 32, 32, 2560, True): 2,
                    (4, 64, 64, 640, False): 5, (4, 32, 32, 1280, False): 6}


class NormPlan(NamedTuple):
    """The kernel's grid: block (ct, s, b) takes channel tile ``ct`` (channel
    vectors ``[ct · tile_vecs, (ct + 1) · tile_vecs)`` of ``vec`` channels
    each) of positions ``[hw · s // splits, hw · (s + 1) // splits)`` of image
    ``b``; its ``tile_vecs · rows`` threads take ``rows`` positions a step."""
    vec: int
    tile_vecs: int
    rows: int
    ctiles: int
    splits: int

    @property
    def threads(self) -> int:
        return self.tile_vecs * self.rows


def norm_plan(batch: int, hw: int, c: int) -> NormPlan:
    """The plan of both passes for x (batch, hw, c): channel tiles as even as
    ``NORM_THREADS`` threads allow, as many positions a step as fill a block,
    and as many position ranges an image as make one wave of
    ``NORM_BLOCKS_PER_SM`` blocks on each of ``SMS`` multiprocessors (each
    range at least one step). It reads no device, so the order of every sum
    is fixed by the shapes."""
    vec = 8 if c % 8 == 0 else 1
    nv = c // vec
    ctiles = -(-nv // NORM_THREADS)
    tile_vecs = -(-nv // ctiles)
    rows = NORM_THREADS // tile_vecs
    splits = max(1, min(SMS * NORM_BLOCKS_PER_SM // (batch * ctiles), -(-hw // rows), 65535))
    return NormPlan(vec, tile_vecs, rows, ctiles, splits)


def combine_slices(plan: NormPlan, groups: int) -> list:
    """The order in which an apply block adds its image's partials (entry
    ``s · ctiles + ct`` is block (ct, s)'s): slice ``r`` adds entries ``r``,
    ``r + R``, … in turn, then the R slices are added in order, R the
    block's threads over ``2 · groups``."""
    entries, slices = plan.splits * plan.ctiles, plan.threads // (2 * groups)
    return [list(range(r, entries, slices)) for r in range(slices)]


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
    plan = norm_plan(b, h * w, c)
    part = torch.empty((b, plan.splits, plan.ctiles, 2, groups), **f32)
    out = torch.empty_like(x)
    lib = _build.lib()
    fused_group_norm.launches += 1
    code = lib.dg_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(), out.data_ptr(), b,
        h * w, c, groups, plan.tile_vecs, plan.rows, plan.ctiles, plan.splits, eps, int(silu),
        int(x.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
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
