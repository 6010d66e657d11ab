"""ResNet and Res2Net backbones (torch), NHWC.

Counterpart of ``divergen_tpu/modeling/backbone/resnet.py``: ``Bottleneck``,
``ResNet`` (depths 18–152 of ``_BLOCKS``, every depth on bottleneck blocks,
18 and 34 included), ``Bottle2neck`` and ``Res2Net`` (the v1b deep stem, 26w ×
4s). Both emit the stage features ``res2..res5`` named in ``out_features``
(strides 4 / 8 / 16 / 32). The stride of a downsampling block sits in its
first 1×1 conv (``stride_in_1x1``, the JAX default, which ``build_model``
never changes); the stem's max-pool pads one −inf row and column on each
side; ``Bottle2neck``'s average pool counts its zero padding. Children carry
the flax scope names (``stem``, ``res2_block0.conv1``, ``res3_block0.shortcut``,
``stem1``, ``res4_block2.conv2_1``, …).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvNorm, avg_pool, max_pool

_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
           152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 with a projection shortcut where the shape changes."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, norm: str = "FrozenBN", stride_in_1x1: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvNorm(in_channels, bottleneck_channels, 1, s1, norm, F.relu, **kw)
        self.conv2 = ConvNorm(bottleneck_channels, bottleneck_channels, 3, s3, norm, F.relu, **kw)
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1, 1, norm, None, **kw)
        self.shortcut = None
        if in_channels != out_channels or stride != 1:
            self.shortcut = ConvNorm(in_channels, out_channels, 1, stride, norm, None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(out + x)


class ResNet(nn.Module):
    """detectron2's BasicStem (7×7/2 conv, 3×3/2 max-pool) and four stages of
    bottleneck blocks, widths doubling from ``res2_out_channels``."""

    def __init__(self, depth: int = 50, norm: str = "FrozenBN",
                 out_features: Sequence[str] = ("res3", "res4", "res5"),
                 stem_out_channels: int = 64, res2_out_channels: int = 256,
                 stride_in_1x1: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvNorm(3, stem_out_channels, 7, 2, norm, F.relu, **kw)
        self.blocks = []
        cin, out_ch = stem_out_channels, res2_out_channels
        for stage, n in enumerate(_BLOCKS[depth]):
            for i in range(n):
                name = f"res{stage + 2}_block{i}"
                stride = 2 if stage > 0 and i == 0 else 1
                self.add_module(name, Bottleneck(cin, out_ch, out_ch // 4, stride, norm,
                                                 stride_in_1x1, **kw))
                self.blocks.append(name)
                cin = out_ch
            out_ch *= 2

    @staticmethod
    def out_channels(depth: int, res2_out_channels: int = 256) -> Dict[str, int]:
        return {f"res{i + 2}": res2_out_channels * 2 ** i for i in range(4)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = max_pool(self.stem(x), 3, 2, 1)
        outputs = {}
        for name in self.blocks:
            x = getattr(self, name)(x)
            stage = name.split("_")[0]
            if stage in self.out_features:
                outputs[stage] = x  # the stage's last block overwrites
        return outputs


class Bottle2neck(nn.Module):
    """Res2Net bottleneck: the middle 3×3 becomes ``scale − 1`` convs over
    channel splits. A ``normal`` block adds the previous split's output to
    the next split's input; a ``stage`` block (stride or width change) does
    not, and average-pools its last split when it strides."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, scale: int = 4, norm: str = "FrozenBN",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.scale = stride, scale
        self.stage = stride != 1 or in_channels != out_channels
        width = bottleneck_channels // scale
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvNorm(in_channels, bottleneck_channels, 1, 1, norm, F.relu, **kw)
        for i in range(scale - 1):
            self.add_module(f"conv2_{i}", ConvNorm(width, width, 3, stride, norm, F.relu, **kw))
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1, 1, norm, None, **kw)
        self.shortcut = None
        if self.stage:
            self.shortcut = ConvNorm(in_channels, out_channels, 1, stride, norm, None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        splits = torch.chunk(self.conv1(x), self.scale, dim=-1)
        outs, prev = [], None
        for i in range(self.scale - 1):
            sp = splits[i] if i == 0 or self.stage else splits[i] + prev
            prev = getattr(self, f"conv2_{i}")(sp)
            outs.append(prev)
        last = splits[-1]
        if self.stage and self.stride != 1:
            last = avg_pool(last, 3, self.stride, 1)
        out = self.conv3(torch.cat(outs + [last.to(prev.dtype)], dim=-1))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(out + x)


class Res2Net(nn.Module):
    """Res2Net-v1b: a deep stem (three 3×3 convs, 32 / 32 / 64, then the
    3×3/2 max-pool) and four stages of ``Bottle2neck`` blocks."""

    def __init__(self, depth: int = 50, width: int = 26, scale: int = 4, norm: str = "FrozenBN",
                 out_features: Sequence[str] = ("res3", "res4", "res5"),
                 res2_out_channels: int = 256, dtype=torch.float32, device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        kw = dict(dtype=dtype, device=device)
        self.stem1 = ConvNorm(3, 32, 3, 2, norm, F.relu, **kw)
        self.stem2 = ConvNorm(32, 32, 3, 1, norm, F.relu, **kw)
        self.stem3 = ConvNorm(32, 64, 3, 1, norm, F.relu, **kw)
        self.blocks = []
        cin, out_ch, w = 64, res2_out_channels, width
        for stage, n in enumerate(_BLOCKS[depth]):
            for i in range(n):
                name = f"res{stage + 2}_block{i}"
                stride = 2 if stage > 0 and i == 0 else 1
                self.add_module(name, Bottle2neck(cin, out_ch, w * scale, stride, scale, norm,
                                                  **kw))
                self.blocks.append(name)
                cin = out_ch
            out_ch *= 2
            w *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = max_pool(self.stem3(self.stem2(self.stem1(x))), 3, 2, 1)
        outputs = {}
        for name in self.blocks:
            x = getattr(self, name)(x)
            stage = name.split("_")[0]
            if stage in self.out_features:
                outputs[stage] = x
        return outputs
