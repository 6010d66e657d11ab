"""Fused GroupNorm → SiLU → 3×3 conv over NHWC activations: hand-written CUDA
kernel on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/fused_gn_conv.py:
fused_gn_silu_conv3x3``, with its semantics kept exactly:

* **groups** is the largest divisor of C that is at most ``groups`` (not
  ``gcd(32, C)``: the two differ at C = 48, 24 groups against 16);
* **moments** are per-(B, C) ``E[x]`` and ``E[x²]`` over (H, W) in f32,
  averaged within each group; ``rstd = rsqrt(E[x²] − mean² + eps)`` takes no
  clamp (``ops/group_norm.py`` clamps, this function does not);
* they fold into per-(B, C) ``a = rstd · scale`` and ``b = bias − mean · a``,
  and ``y = silu(x · a + b)``;
* **y and the conv weight are rounded to bfloat16**, whatever x's dtype; the
  3×3 conv pads y with zeros (after the affine, so the border is 0, not
  ``silu(b)``), sums in f32 and adds the conv bias in f32; the output is in
  x's dtype.

For a CUDA tensor :func:`fused_gn_silu_conv3x3` launches
``csrc/gn_conv.cu`` (bf16 or f32 x, any shape) through two C entry points:
``dg_gn_conv_apply`` (kernel 7's moments pass, the fold into ``a`` and ``b``,
then ``y = bf16(silu(x · a + b))`` once per element into (B, H, W, Cp) bf16
scratch, Cp = C rounded up to 8) and ``dg_gn_conv_gemm`` (the conv as a
persistent, warp-specialized wgmma + TMA implicit GEMM over y, whose zero
padding is TMA's fill outside the tensor; :func:`conv_plan` picks its tiles
and blocks). Its weight operand is a ``(Co, 3, 3, Cp)`` bf16 copy of the
port ``Conv``'s ``(Co, C, 3, 3)`` weight, made on each call as the JAX
function casts its kernel on each call. For a CPU tensor it runs
:func:`fused_gn_silu_conv3x3_reference`. A CUDA tensor the kernel cannot
take raises. Launches (one per call, whatever passes the kernel makes) are
counted in ``fused_gn_silu_conv3x3.launches``.

Forward only, as the JAX kernel (no ``custom_vjp``): on the card a call that
would need a gradient raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .group_norm import moment_splits


def group_count(c: int, groups: int = 32) -> int:
    """The largest divisor of ``c`` that is at most ``groups``."""
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def gn_silu_fold_reference(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                           groups: int = 32, eps: float = 1e-6):
    """The JAX function's moments and fold on the CPU path: per-(B, C) f32
    ``a = rstd · scale`` and ``b = bias − mean · a``, each (B, C)."""
    b, _, _, c = x.shape
    g = group_count(c, groups)
    xf = x.float()
    gm = xf.mean(dim=(1, 2)).view(b, g, c // g).mean(-1)  # means of per-channel means
    g2 = (xf * xf).mean(dim=(1, 2)).view(b, g, c // g).mean(-1)
    inv = torch.rsqrt(g2 - gm * gm + eps)  # no clamp
    a = inv.repeat_interleave(c // g, dim=-1) * gn_scale.float()
    shift = gn_bias.float() - gm.repeat_interleave(c // g, dim=-1) * a
    return a, shift


def fused_gn_silu_conv3x3_reference(x: torch.Tensor, gn_scale: torch.Tensor,
                                    gn_bias: torch.Tensor, weight: torch.Tensor,
                                    bias: torch.Tensor, groups: int = 32,
                                    eps: float = 1e-6) -> torch.Tensor:
    """The JAX function's CPU path op for op: the f32 affine on x, bf16 casts
    of y and the weight, a conv computed in f32 on the bf16-valued operands,
    the f32 bias, then x's dtype. x (B, H, W, C); weight (Co, C, 3, 3)."""
    a, shift = gn_silu_fold_reference(x, gn_scale, gn_bias, groups, eps)
    y = x.float() * a[:, None, None, :] + shift[:, None, None, :]
    y = (y * torch.sigmoid(y)).to(torch.bfloat16)
    out = F.conv2d(y.float().permute(0, 3, 1, 2), weight.to(torch.bfloat16).float(), padding=1)
    return (out.permute(0, 2, 3, 1) + bias.float()).to(x.dtype)


def weight_operand(weight: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand: (Co, C, 3, 3) → (Co, 3, 3, Cp) bf16, the
    (N, K) row-major layout with K = (tap, channel), C rounded up to Cp, a
    multiple of 8 (whole 16-byte chunks), with zeros. One copy, with the cast."""
    co, c = weight.shape[:2]
    cp = -(-c // 8) * 8
    wt = torch.empty((co, 3, 3, cp), device=weight.device, dtype=torch.bfloat16)
    wt[..., :c].copy_(weight.permute(0, 2, 3, 1))
    wt[..., c:].zero_()
    return wt


CONV_BM = 128  # output pixels per tile of the GEMM kernel
CONV_BN = 160  # output channels per tile (csrc/gn_conv.cu: kBN)

# The kernel-8 convs of one UNetSDXL(conv_matmul="fused") call at B = 2
# images, 1024² (UNet batch 4): (B, H, W, C, Co) -> launches, two per
# ResBlock (conv1 C -> Co, conv2 Co -> Co), 34 a call. The shapes the tile
# plan is judged on.
UNET_CONVS = {(4, 128, 128, 320, 320): 7, (4, 128, 128, 640, 320): 2,
              (4, 128, 128, 960, 320): 1, (4, 64, 64, 320, 640): 1,
              (4, 64, 64, 640, 640): 6, (4, 64, 64, 960, 640): 1,
              (4, 64, 64, 1280, 640): 1, (4, 64, 64, 1920, 640): 1,
              (4, 32, 32, 640, 1280): 1, (4, 32, 32, 1280, 1280): 10,
              (4, 32, 32, 1920, 1280): 1, (4, 32, 32, 2560, 1280): 2}


class ConvPlan(NamedTuple):
    """Tiles of the GEMM kernel: th × tw output pixels of one image (th · tw
    = ``CONV_BM``, tw a power of two) by ``CONV_BN`` output channels,
    tiles_m × tiles_n of them on ``blocks`` persistent blocks."""
    th: int
    tw: int
    blocks: int
    tiles_m: int
    tiles_n: int


def conv_plan(b: int, h: int, w: int, co: int, sms: int) -> ConvPlan:
    """The GEMM kernel's tiles for a (B, H, W) map to Co channels on a card
    of ``sms`` SMs.

    Tile t covers channels ``(t % tiles_n) · CONV_BN`` on of pixel tile
    ``t // tiles_n`` (w tiles fastest, then h tiles, then images); block k
    takes tiles k, k + blocks, … and hands them to its two consumer
    warpgroups in turns. tw is the power of two that gives the fewest pixel
    tiles, the widest on a tie: tw = W at SDXL's maps (128, 64, 32), so no
    row of a tile falls outside the image; elsewhere rows past H or W are
    computed on TMA's zeros and not stored. Every Co of SDXL's UNet is a
    multiple of ``CONV_BN``."""
    def pixel_tiles(tw):
        return b * -(-h // (CONV_BM // tw)) * -(-w // tw)

    tw = min((1 << k for k in range(8)), key=lambda t: (pixel_tiles(t), -t))
    th = CONV_BM // tw
    tiles_m, tiles_n = pixel_tiles(tw), -(-co // CONV_BN)
    return ConvPlan(th, tw, min(tiles_m * tiles_n, sms), tiles_m, tiles_n)


def _apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, groups: int, eps: float):
    """The normalized activation of a checked CUDA x (B, H, W, C): (y (B, H,
    W, Cp) bf16, zeros past C; a and b, (B, C) f32 each, the fold)."""
    b, h, w, c = x.shape
    cp = -(-c // 8) * 8
    f32 = dict(device=x.device, dtype=torch.float32)
    splits = moment_splits(b, h * w, c)
    part = torch.empty((b, splits, 2, c), **f32)
    fa = torch.empty((b, c), **f32)
    fs = torch.empty((b, c), **f32)
    y = torch.empty((b, h, w, cp), device=x.device, dtype=torch.bfloat16)
    code = _build.lib().dg_gn_conv_apply(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), part.data_ptr(), fa.data_ptr(),
        fs.data_ptr(), y.data_ptr(), b, h, w, c, cp, groups, splits, eps,
        int(x.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "GroupNorm + SiLU apply pass launch")
    return y, fa, fs


def _conv_gemm(y: torch.Tensor, wt: torch.Tensor, conv_bias: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """The conv GEMM on checked CUDA operands: y (B, H, W, Cp) bf16 from
    :func:`_apply`, wt (Co, 3, 3, Cp) bf16 (:func:`weight_operand`),
    conv_bias (Co,) f32, into out, a contiguous (B, H, W, Co) bf16 or f32
    tensor (or rows of one) on their device."""
    b, h, w, cp = y.shape
    co = wt.shape[0]
    plan = conv_plan(b, h, w, co, torch.cuda.get_device_properties(y.device).multi_processor_count)
    code = _build.lib().dg_gn_conv_gemm(
        y.data_ptr(), wt.data_ptr(), conv_bias.data_ptr(), out.data_ptr(), b, h, w, cp, co,
        plan.tw.bit_length() - 1, plan.blocks, int(out.dtype == torch.float32),
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(code, "GroupNorm + SiLU + conv3x3 GEMM launch")
    return out


def _launch(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    b, h, w, c = x.shape
    co = weight.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_gn_silu_conv3x3: the kernel takes bfloat16 or float32, "
                         f"got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() == 0:
        raise ValueError("fused_gn_silu_conv3x3: the kernel takes a contiguous, 16-byte aligned, "
                         "non-empty x")
    if tuple(weight.shape) != (co, c, 3, 3) or tuple(bias.shape) != (co,) or \
            tuple(gn_scale.shape) != (c,) or tuple(gn_bias.shape) != (c,):
        raise ValueError(f"fused_gn_silu_conv3x3: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}, GroupNorm affine "
                         f"{tuple(gn_scale.shape)}, {tuple(gn_bias.shape)}")
    if any(t.device != x.device for t in (gn_scale, gn_bias, weight, bias)):
        raise ValueError("fused_gn_silu_conv3x3: every operand must be on x's device")
    f32 = dict(device=x.device, dtype=torch.float32)
    scale = gn_scale.to(**f32).contiguous()
    shift = gn_bias.to(**f32).contiguous()
    conv_bias = bias.to(**f32).contiguous()
    wt = weight_operand(weight)
    out = torch.empty((b, h, w, co), device=x.device, dtype=x.dtype)
    fused_gn_silu_conv3x3.launches += 1
    y, _, _ = _apply(x, scale, shift, group_count(c, groups), eps)
    return _conv_gemm(y, wt, conv_bias, out)


def fused_gn_silu_conv3x3(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, groups: int = 32,
                          eps: float = 1e-6) -> torch.Tensor:
    """``conv3x3(silu(groupnorm(x))) + bias``, padding 1. x (B, H, W, C)
    NHWC; gn_scale, gn_bias (C,); weight (Co, C, 3, 3), the port ``Conv``'s
    layout; bias (Co,). Returns (B, H, W, Co) in x's dtype."""
    if x.device.type == "cpu":
        return fused_gn_silu_conv3x3_reference(x, gn_scale, gn_bias, weight, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv3x3: x on {x.device}; the kernel needs CUDA")
    _build.require_no_grad("fused_gn_silu_conv3x3", x, gn_scale, gn_bias, weight, bias)
    return _launch(x, gn_scale, gn_bias, weight, bias, groups, eps)


fused_gn_silu_conv3x3.launches = 0
