"""Layers shared by the port's models, and flax-style random initialization.

The JAX package's flax modules keep their parameters in float32
(``param_dtype``) and cast dense and conv weights and biases to the module's
compute ``dtype`` at apply time, while norms keep float32 scale and bias. The
port has one rule for ``Dense``, ``Conv`` and ``ConvTranspose``: a layer is
built in its compute ``dtype`` and stores its parameters there, so nothing is
cast per call (the inference entry points: bfloat16-stored weights).
``set_param_dtype_(model, torch.float32)`` then moves the storage of a built
model: the parameters, and so the gradients, the optimizer state and the EMA
copy, are float32 and are cast to the compute dtype at apply time as flax casts
them (the training entry points). ``LayerNorm`` always holds float32. Activations are NHWC, as in the JAX package; ``Conv`` and
``ConvTranspose`` hand the convolution a channels-last NCHW view and return
NHWC again. flax ``nn.LayerNorm`` defaults to eps 1e-6, the port's
``LayerNorm`` to torch's 1e-5: the ViT and SAM modules pass 1e-6, CLIP and
Swin 1e-5.

The detector's blocks (``FrozenBatchNorm``, ``GroupNorm``, ``get_norm``,
``ConvNorm``, ``Scale``, ``DropPath``) mirror ``divergen_tpu/modeling/layers.py``:
a norm that flax creates inside a compact module sits in a child named after
its class (``ConvNorm.GroupNorm_0``), and like flax norms with float32
parameters these return float32 whatever the input's dtype.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F


class _CastAtApply:
    """The dtype rule of ``Dense``, ``Conv`` and ``ConvTranspose``.
    ``compute_dtype`` is None while the parameters are stored in the dtype
    they compute in."""

    compute_dtype: Optional[torch.dtype] = None

    def _operands(self, x: torch.Tensor):
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), self.weight.to(dt), bias


@torch.no_grad()
def set_param_dtype_(module: nn.Module, param_dtype: torch.dtype) -> nn.Module:
    """Store the parameters of every ``Dense``, ``Conv`` and ``ConvTranspose``
    under ``module`` in ``param_dtype``; each layer goes on computing in the
    dtype it computed in before."""
    for mod in module.modules():
        if isinstance(mod, _CastAtApply) and mod.weight.dtype != param_dtype:
            compute = mod.compute_dtype or mod.weight.dtype
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(param_dtype)
            mod.compute_dtype = None if compute == param_dtype else compute
    return module


class Dense(_CastAtApply, nn.Linear):
    """flax ``nn.Dense``: input, weight and bias in the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*self._operands(x))


def same_pads(n: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """flax ``padding="SAME"`` along one axis of extent ``n``: the total
    ``max((ceil(n / s) - 1) · s + k' - n, 0)`` (k' the dilated kernel), low
    half first."""
    k = (k - 1) * dilation + 1
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(_CastAtApply, nn.Conv2d):
    """flax ``nn.Conv`` on NHWC activations. ``padding`` defaults to the
    symmetric k // 2; a patch embedding (stride = kernel) passes 0, and
    ``padding="SAME"`` pads as flax's default does, from the input's extent
    (asymmetric where the stride does not divide it). ``groups`` and
    ``dilation`` are flax's ``feature_group_count`` and
    ``kernel_dilation``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dtype=None, device=None, bias: bool = True,
                 padding: Union[int, str, None] = None, groups: int = 1, dilation: int = 1):
        self.flax_same = padding == "SAME"
        pad = 0 if self.flax_same else kernel_size // 2 if padding is None else padding
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=pad,
                         dilation=dilation, groups=groups, bias=bias, dtype=dtype,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self._operands(x)
        if self.flax_same:
            (k, _), (s, _), (d, _) = self.kernel_size, self.stride, self.dilation
            ph, pw = same_pads(x.shape[1], k, s, d), same_pads(x.shape[2], k, s, d)
            if any(ph + pw):
                x = F.pad(x, (0, 0, *pw, *ph))
        y = self._conv_forward(x.permute(0, 3, 1, 2), weight, bias)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(_CastAtApply, nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` with kernel = stride (an exact ×stride
    upsampling) on NHWC activations. torch keeps the weight as (in, out, kh,
    kw) in scatter form; ``utils.convert.params_from_jax`` flips and
    transposes flax's (kh, kw, in, out) kernel into it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 2,
                 dtype=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=kernel_size,
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self._operands(x)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias, self.stride)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: float32 statistics and affine, output in the
    input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__(channels, eps=eps, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """Affine-only batch norm, ``y = x * scale + bias`` with the frozen
    statistics folded into the two vectors (float32; flax names ``scale`` and
    ``bias``, here ``weight`` and ``bias``)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight + self.bias


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` over NHWC: float32 statistics (var = E[x²] −
    E[x]²) and affine, float32 output. The moments are taken per channel over
    (H, W) and combined within each group, a reduction over the leading
    spatial axes with no copy to NCHW."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5, device=None):
        super().__init__(num_groups, channels, eps=eps, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        per_group = c // self.num_groups
        xf = x.float()
        mean = xf.mean(dim=(1, 2)).view(b, self.num_groups, per_group).mean(-1)
        var = xf.square().mean(dim=(1, 2)).view(b, self.num_groups, per_group).mean(-1)
        var = (var - mean * mean).clamp(min=0.0)
        scale = torch.rsqrt(var + self.eps).repeat_interleave(per_group, dim=-1) * self.weight
        shift = self.bias - mean.repeat_interleave(per_group, dim=-1) * scale
        return torch.addcmul(shift[:, None, None], xf, scale[:, None, None])


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)``: the stored statistics
    normalize in training as at inference, ``y = (x − mean) · rsqrt(var +
    eps) · weight + bias`` in float32, returned in ``dtype``. The statistics
    are buffers (flax's ``batch_stats`` collection: ``mean``, ``var``), so no
    optimizer sees them."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * mul + self.bias).to(self.dtype)


def max_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0) -> torch.Tensor:
    """flax ``nn.max_pool`` on NHWC; ``padding`` pads −inf on every side (0
    is flax's "VALID", which floors an odd extent)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0) -> torch.Tensor:
    """flax ``nn.avg_pool`` on NHWC with zero padding counted in the mean
    (flax's default ``count_include_pad=True``)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride, padding, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of axes 1 and 2 to (h, w): output
    index i reads input ``floor((i + 0.5) · n_in / n_out)`` (half-pixel
    centres), computed in float32 in that order, as JAX computes it."""
    for axis, n in ((1, h), (2, w)):
        m = x.shape[axis]
        if m != n:
            src = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n).floor()
            x = x.index_select(axis, src.long())
    return x


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``jax.image.resize(..., "bilinear")`` for an upscale: half-pixel
    centres, taps past an edge dropped and the rest renormalized, which is
    ``F.interpolate(align_corners=False)``'s clamp to the edge sample."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def get_norm(norm: Optional[str], features: int, device=None) -> Optional[nn.Module]:
    """The norm layer a config string names, or None. "GN" is 32 groups (25
    when the channels do not divide by 32); "BN" and "SyncBN" map to a
    GroupNorm of gcd(32, features) groups, as in the JAX package."""
    if norm in ("", "none", None):
        return None
    if norm == "GN":
        return GroupNorm(32 if features % 32 == 0 else 25, features, eps=1e-5, device=device)
    if norm == "FrozenBN":
        return FrozenBatchNorm(features, device=device)
    if norm == "LN":
        return LayerNorm(features, eps=1e-6, device=device)
    if norm in ("SyncBN", "BN"):
        return GroupNorm(math.gcd(32, features), features, eps=1e-5, device=device)
    raise ValueError(f"Unknown norm: {norm}")


def add_norm(module: nn.Module, norm: Optional[str], features: int,
             device=None) -> Optional[str]:
    """Add the norm a config string names (``get_norm``) to ``module`` under
    its flax name (``GroupNorm_0``, ``FrozenBatchNorm_0``, ``LayerNorm_0``)
    and return that name; None, adding nothing, for no norm."""
    layer = get_norm(norm, features, device=device)
    if layer is None:
        return None
    name = f"{'GroupNorm' if isinstance(layer, GroupNorm) else type(layer).__name__}_0"
    module.add_module(name, layer)
    return name


class ConvNorm(nn.Module):
    """Conv + optional norm + optional activation on NHWC. The convolution
    pads k // 2 on every side at any stride, and has a bias unless a norm
    other than GN follows (``use_bias`` overrides). Children: ``conv`` and
    the norm under its flax name (``GroupNorm_0``, ``FrozenBatchNorm_0``,
    ``LayerNorm_0``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, strides: int = 1,
                 norm: str = "", activation: Optional[Callable] = None,
                 use_bias: Optional[bool] = None, dtype=None, device=None):
        super().__init__()
        bias = use_bias if use_bias is not None else norm in ("", "GN")
        self.conv = Conv(in_channels, features, kernel_size, stride=strides, bias=bias,
                         dtype=dtype, device=device)
        self.norm_name = add_norm(self, norm, features, device)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier (a ``()`` float32 parameter named
    ``scale`` in flax, ``weight`` here); the product is at least float32."""

    def __init__(self, init_value: float = 1.0, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(float(init_value), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.promote_types(x.dtype, self.weight.dtype)) * self.weight


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity when ``deterministic`` (the
    inference forward) or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device, generator=generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


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
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        raw: Dict[str, float] = getattr(mod, "raw_init_std", {})
        for name, std in raw.items():
            if hasattr(mod, name):  # an optional parameter may be absent
                getattr(mod, name).normal_(0.0, std, generator=gen)
    return module
