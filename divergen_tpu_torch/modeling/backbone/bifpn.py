"""BiFPN, the bidirectional feature pyramid (torch), NHWC.

Counterpart of ``divergen_tpu/modeling/backbone/bifpn.py``: 1×1 laterals onto
``out_channels``, two extra levels by 2×2 max-pools (flax "VALID": odd
extents floor), then ``num_layers`` ``BiFPNLayer``s of fast-normalized fusion
``Σ relu(wᵢ)·xᵢ / (Σ relu(wᵢ) + 1e-4)``, each fusion followed by a separable
conv (3×3 depthwise, 1×1 pointwise, BatchNorm, swish). The BatchNorm
normalizes with its stored statistics in training too (flax
``use_running_average=True``): they are buffers, mapped from flax's
``batch_stats`` by ``utils.convert.params_from_jax``. A coarser level reaches
a finer one by nearest resizing with half-pixel centres
(``jax.image.resize``), a finer one a coarser by the 2×2 max-pool. Children
carry the flax scope names (``lateral_dla3``, ``layer0.td2.conv.depthwise``,
``layer1.bu4.fuse_weights``, …).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv, max_pool, resize_nearest


class SeparableConv(nn.Module):
    def __init__(self, in_channels: int, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.depthwise = Conv(in_channels, in_channels, 3, padding=1, groups=in_channels,
                              bias=False, **kw)
        self.pointwise = Conv(in_channels, channels, 1, **kw)
        self.bn = BatchNorm(channels, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.pointwise(self.depthwise(x))))


class _Fuse(nn.Module):
    def __init__(self, n_inputs: int, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fuse_weights = nn.Parameter(torch.ones(n_inputs, device=device))
        self.conv = SeparableConv(channels, channels, dtype, device)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        w = F.relu(self.fuse_weights)
        # float32 weights promote the sum to float32, as in JAX (a 0-d tensor
        # would not promote a bfloat16 operand in torch)
        out = sum(w[i] * xs[i].float() for i in range(len(xs))) / (w.sum() + 1e-4)
        return self.conv(out)


def _resize_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    h, w = ref.shape[1], ref.shape[2]
    if (x.shape[1], x.shape[2]) == (h, w):
        return x
    if x.shape[1] > h:
        return max_pool(x, 2, 2)
    return resize_nearest(x, h, w)


class BiFPNLayer(nn.Module):
    """One top-down then bottom-up pass over ``num_levels`` levels."""

    def __init__(self, channels: int, num_levels: int = 5, dtype=torch.float32, device=None):
        super().__init__()
        self.num_levels = num_levels
        for i in range(num_levels - 2, -1, -1):
            self.add_module(f"td{i}", _Fuse(2, channels, dtype, device))
        for i in range(1, num_levels):
            self.add_module(f"bu{i}", _Fuse(3 if i < num_levels - 1 else 2, channels, dtype,
                                            device))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        n = self.num_levels
        td = [None] * n
        td[n - 1] = feats[n - 1]
        for i in range(n - 2, -1, -1):
            td[i] = getattr(self, f"td{i}")([feats[i], _resize_to(td[i + 1], feats[i])])
        out = [td[0]] + [None] * (n - 1)
        for i in range(1, n):
            xs = [feats[i], td[i], _resize_to(out[i - 1], feats[i])]
            out[i] = getattr(self, f"bu{i}")(xs if i < n - 1 else xs[:2])
        return out


class BiFPN(nn.Module):
    """Bottom-up features (fine → coarse, ``in_channels`` each) → p3..p7 of
    ``out_channels``; the first level takes its number from the last
    character of ``in_features[0]``."""

    def __init__(self, in_features: Sequence[str], in_channels: Sequence[int],
                 out_channels: int = 160, num_layers: int = 3, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.in_features, self.num_layers = tuple(in_features), num_layers
        for f, c in zip(self.in_features, in_channels):
            self.add_module(f"lateral_{f}", Conv(c, out_channels, 1, dtype=dtype, device=device))
        for li in range(num_layers):
            self.add_module(f"layer{li}", BiFPNLayer(out_channels, 5, dtype, device))
        tail = self.in_features[0][-1]
        self.base_level = int(tail) if tail.isdigit() else 3

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = [getattr(self, f"lateral_{f}")(bottom_up[f]) for f in self.in_features]
        while len(feats) < 5:
            feats.append(max_pool(feats[-1], 2, 2))
        for li in range(self.num_layers):
            feats = getattr(self, f"layer{li}")(feats)
        return {f"p{self.base_level + i}": x for i, x in enumerate(feats)}
