"""Layers shared by the port's models, and flax-style random initialization.

The JAX package's flax modules keep their parameters in float32 and cast
dense and conv weights to the module's compute ``dtype`` at apply time, while
norms keep float32 scale and bias. The port stores weights the same way:
``Dense`` and ``Conv`` hold theirs in the compute dtype, ``LayerNorm`` holds
float32. Activations are NHWC, as in the JAX package; ``Conv`` and
``ConvTranspose`` hand the convolution a channels-last NCHW view and return
NHWC again. flax ``nn.LayerNorm`` defaults to eps 1e-6, the port's
``LayerNorm`` to torch's 1e-5: the ViT and SAM modules pass 1e-6, CLIP 1e-5.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """flax ``nn.Dense``: casts its input to the weight's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NHWC activations. ``padding`` defaults to the
    "SAME"-style k // 2; a patch embedding (stride = kernel) passes 0."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dtype=None, device=None, bias: bool = True,
                 padding: Optional[int] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2 if padding is None else padding,
                         bias=bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.to(self.weight.dtype).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` with kernel = stride (an exact ×stride
    upsampling) on NHWC activations. torch keeps the weight as (in, out, kh,
    kw) in scatter form; ``utils.convert.params_from_jax`` flips and
    transposes flax's (kh, kw, in, out) kernel into it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 dtype=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=kernel_size,
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.to(self.weight.dtype).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: float32 statistics and affine, output in the
    input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__(channels, eps=eps, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


# flax lecun_normal: variance_scaling(1, "fan_in", "truncated_normal") draws
# from a normal truncated at ±2σ, with σ rescaled so the variance is 1/fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    tmp.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen).erfinv_()
    tmp.mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
    w.copy_(tmp)


@torch.no_grad()
def flax_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random weights as the JAX package's flax modules draw them (not the same
    bits): lecun-normal dense/conv kernels, zero biases, unit norm scales,
    normal(1/√features) embeddings, and each raw parameter with the normal
    std its module lists in ``raw_init_std``."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            # fan_in: in_features, or in_channels · kh · kw
            _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.ConvTranspose2d):
            # weight (in, out, kh, kw); fan_in = in_channels · kh · kw
            _lecun_normal_(mod.weight, mod.weight[:, 0].numel(), gen)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.embedding_dim ** -0.5, generator=gen)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        raw: Dict[str, float] = getattr(mod, "raw_init_std", {})
        for name, std in raw.items():
            getattr(mod, name).normal_(0.0, std, generator=gen)
    return module
