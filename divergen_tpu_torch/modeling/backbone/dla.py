"""DLA-34, deep layer aggregation (torch), NHWC.

Counterpart of the part of ``divergen_tpu/modeling/backbone/dla.py`` that
``build_model`` reaches: ``BasicBlock``, ``Root``, ``Tree`` and ``DLA34``
(channels 16, 32, 64, 128, 256, 512; tree levels 1, 2, 2, 1), emitting
``dla3..dla5`` (strides 8 / 16 / 32). Its norm is the JAX default "BN",
which ``get_norm`` maps to a GroupNorm. ``IDAUp``, ``DLAUp`` and
``DeformNode`` (with the deformable convolution) are on no ``build_model``
path and are not ported. Children carry the flax scope names (``base``,
``level0``, ``level3.tree1.tree2.root.conv``, …).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvNorm

OUT_CHANNELS = {"dla2": 64, "dla3": 128, "dla4": 256, "dla5": 512}


class BasicBlock(nn.Module):
    """Two 3×3 convs and a residual, projected where its shape differs."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1, norm: str = "BN",
                 dtype=torch.float32, device=None, residual_channels: Optional[int] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvNorm(in_channels, channels, 3, stride, norm, F.relu, **kw)
        self.conv2 = ConvNorm(channels, channels, 3, 1, norm, None, **kw)
        rc = in_channels if residual_channels is None else residual_channels
        self.project = None
        if rc != channels or stride != 1:
            self.project = ConvNorm(rc, channels, 1, stride, norm, None, **kw)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x if residual is None else residual
        out = self.conv2(self.conv1(x))
        if self.project is not None:
            residual = self.project(residual)
        return F.relu(out + residual)


class Root(nn.Module):
    """Concatenation → 1×1 conv + norm → ReLU."""

    def __init__(self, in_channels: int, channels: int, norm: str = "BN", dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv = ConvNorm(in_channels, channels, 1, 1, norm, None, dtype=dtype, device=device)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return F.relu(self.conv(torch.cat(list(xs), dim=-1)))


class Tree(nn.Module):
    def __init__(self, levels: int, in_channels: int, channels: int, stride: int = 1,
                 norm: str = "BN", dtype=torch.float32, device=None):
        super().__init__()
        self.levels = levels
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, channels, stride, norm, dtype, device)
            self.tree2 = BasicBlock(channels, channels, 1, norm, dtype, device)
            self.root = Root(2 * channels, channels, norm, dtype, device)
        else:
            self.tree1 = Tree(levels - 1, in_channels, channels, stride, norm, dtype, device)
            self.tree2 = Tree(levels - 1, channels, channels, 1, norm, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.levels == 1:
            b1 = self.tree1(x)
            return self.root([self.tree2(b1), b1])
        return self.tree2(self.tree1(x))


class DLA34(nn.Module):
    def __init__(self, norm: str = "BN", out_features: Sequence[str] = ("dla3", "dla4", "dla5"),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        chans = (16, 32, 64, 128, 256, 512)
        kw = dict(dtype=dtype, device=device)
        self.base = ConvNorm(3, chans[0], 7, 1, norm, F.relu, **kw)
        self.level0 = ConvNorm(chans[0], chans[0], 3, 1, norm, F.relu, **kw)
        self.level1 = ConvNorm(chans[0], chans[1], 3, 2, norm, F.relu, **kw)
        for i, (ch, lv) in enumerate(zip(chans[2:], (1, 2, 2, 1))):
            self.add_module(f"level{i + 2}", Tree(lv, chans[i + 1], ch, 2, norm, **kw))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.level1(self.level0(self.base(x)))
        outs = {}
        for i in range(4):
            x = getattr(self, f"level{i + 2}")(x)
            if f"dla{i + 2}" in self.out_features:
                outs[f"dla{i + 2}"] = x
        return outs
