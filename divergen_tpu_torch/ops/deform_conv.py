"""Deformable convolution v1 / v2 on NHWC, plain torch.

Counterpart of ``divergen_tpu/ops/deform_conv.py``, which computes it in
plain XLA with no Pallas kernel; so plain torch is the port, on either
device. For every output position and kernel tap the input is sampled
bilinearly at ``position · stride − padding + tap · dilation + offset``
(zeros outside ``(−1, H) × (−1, W)``, the corners clamped into the image as
``_bilinear_hwc`` clamps them), the samples of a position are laid out as one
row of K·K·Cin columns, and one product with the (K·K·Cin, Cout) kernel gives
the output. Without ``mask`` it is v1; with it, v2 ("modulated"), each
sampled tap times its mask value as given (apply the sigmoid at the call
site, as torchvision's ``deform_conv2d`` expects). Differentiable through
autograd in the input, the offsets, the mask, the kernel and the bias.
"""
from __future__ import annotations

from typing import Optional

import torch


def _bilinear_hwc(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); y, x (B, ...) → (B, ..., C), zeros outside."""
    b, h, w, c = img.shape
    inb = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y = y.clamp(0.0, h - 1.0)
    x = x.clamp(0.0, w - 1.0)
    y0, x0 = y.floor(), x.floor()
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    flat = img.reshape(b, h * w, c)
    lead = y.shape[1:]

    def at(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return flat.gather(1, idx).reshape(b, *lead, c)

    out = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
           + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)
    return out * inb[..., None]


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, kernel: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                  dilation: int = 1, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, Cin); offset (B, Ho, Wo, 2·K·K) as (dy, dx) per tap, taps
    in row-major order; kernel (K, K, Cin, Cout); mask (B, Ho, Wo, K·K) or
    None; bias (Cout,) or None → (B, Ho, Wo, Cout)."""
    b, h, w, cin = x.shape
    k = kernel.shape[0]
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    if offset.shape[1:3] != (ho, wo):
        raise ValueError(f"offset {tuple(offset.shape)} is not (B, {ho}, {wo}, 2·K·K)")
    dev = x.device
    oy = torch.arange(ho, device=dev) * stride - padding
    ox = torch.arange(wo, device=dev) * stride - padding
    taps = torch.arange(k, device=dev) * dilation
    gy = (oy[:, None, None, None] + taps[None, None, :, None]).to(offset.dtype)  # (Ho, 1, K, 1)
    gx = (ox[None, :, None, None] + taps[None, None, None, :]).to(offset.dtype)  # (1, Wo, 1, K)
    off = offset.reshape(b, ho, wo, k, k, 2)
    samp = _bilinear_hwc(x, gy + off[..., 0], gx + off[..., 1])  # (B, Ho, Wo, K, K, Cin)
    if mask is not None:
        samp = samp * mask.reshape(b, ho, wo, k, k, 1)
    out = samp.reshape(b, ho, wo, k * k * cin) @ kernel.reshape(k * k * cin, -1)
    return out if bias is None else out + bias
