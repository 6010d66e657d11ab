"""DLA-34, deep layer aggregation (torch), NHWC.

Counterpart of ``divergen_tpu/modeling/backbone/dla.py``: ``BasicBlock``,
``Root``, ``Tree`` and ``DLA34`` (channels 16, 32, 64, 128, 256, 512; tree
levels 1, 2, 2, 1), emitting ``dla3..dla5`` (strides 8 / 16 / 32), whose norm
is the JAX default "BN", which ``get_norm`` maps to a GroupNorm; and the
aggregation over its levels, ``DeformNode``, ``IDAUp`` and ``DLAUp``
(default norm ``FrozenBN``), which no ``build_model`` reaches in either
package (it reads no ``MODEL.DLA.*``): they are built as modules. Children
carry the flax scope names (``base``, ``level0``,
``level3.tree1.tree2.root.conv``, ``ida.node_1.offset``, …).

``DeformNode``'s raw flax parameter ``kernel`` (3, 3, Cin, Cout) is held as
``weight`` (Cout, Cin, 3, 3), the layout ``utils.convert.params_from_jax``
gives every rank-4 ``kernel``, and taken back to (3, 3, Cin, Cout) in
float32 for ``ops.deform_conv.deform_conv2d``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.deform_conv import deform_conv2d
from ..layers import Conv, ConvNorm, add_norm, resize_bilinear

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


class DeformNode(nn.Module):
    """DCN aggregation node (CenterNet2's ``dlafpn.py`` DeformConv): a 3×3
    conv, zero at the start, predicts 27 channels split into thirds as
    (offset_x, offset_y, mask); the offsets are stacked (dy, dx) per tap, the
    mask goes through a sigmoid, and a modulated deformable conv of the
    float32 kernel is followed by the norm and a ReLU."""

    def __init__(self, in_channels: int, channels: int, norm: str = "FrozenBN",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.offset = Conv(in_channels, 27, 3, dtype=dtype, device=device)
        nn.init.zeros_(self.offset.weight)
        nn.init.zeros_(self.offset.bias)
        self.weight = nn.Parameter(torch.empty(channels, in_channels, 3, 3, device=device))
        nn.init.kaiming_normal_(self.weight, nonlinearity="linear")  # variance 1 / fan_in
        self.norm_name = add_norm(self, norm, channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        off_x, off_y, mask = self.offset(x).float().chunk(3, dim=-1)
        offset = torch.stack([off_y, off_x], dim=-1).reshape(*off_x.shape[:-1], 18)
        kernel = self.weight.float().permute(2, 3, 1, 0)
        y = deform_conv2d(x.float(), offset, kernel, mask=torch.sigmoid(mask), stride=1,
                          padding=1).to(self.dtype)
        if self.norm_name is not None:
            y = getattr(self, self.norm_name)(y)
        return F.relu(y)


class IDAUp(nn.Module):
    """Iterative deep aggregation (``dlafpn.py`` IDAUp) over levels finest
    first: ``proj_i`` takes level i to ``channels``, is upsampled by
    ``2**i`` (``jax.image.resize``'s bilinear) and cropped to the finer map,
    and ``node_i`` fuses it with the running sum; ``conv`` or ``dcn``
    nodes."""

    def __init__(self, in_channels: Sequence[int], channels: int, node_type: str = "conv",
                 norm: str = "FrozenBN", dtype=torch.float32, device=None):
        super().__init__()
        if node_type not in ("conv", "dcn"):
            raise ValueError(f"node type {node_type!r} is not 'conv' or 'dcn'")

        def node(cin):
            if node_type == "dcn":
                return DeformNode(cin, channels, norm, dtype, device)
            return ConvNorm(cin, channels, 3, 1, norm, F.relu, dtype=dtype, device=device)

        self.levels = len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"proj_{i}", node(cin))
            if i:
                self.add_module(f"node_{i}", node(channels))

    def forward(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        out = self.proj_0(layers[0])
        for i in range(1, self.levels):
            proj = getattr(self, f"proj_{i}")(layers[i])
            _, h, w, _ = proj.shape
            up = resize_bilinear(proj, 2 ** i * h, 2 ** i * w)[:, :out.shape[1], :out.shape[2]]
            out = getattr(self, f"node_{i}")(up + out)
        return out


class DLAUp(nn.Module):
    """Top-down aggregation of DLA's levels (``DLAUP_NODE_MAP`` 'conv' or
    'dcn'): the features sorted by name (dla2..dla5, finest first) through
    one ``IDAUp`` named ``ida``; returns ``{"dlaup": fused, **features}``.
    ``in_channels`` maps each feature's name to its channels."""

    def __init__(self, in_channels: Mapping[str, int], out_channels: int = 64,
                 node_type: str = "conv", norm: str = "FrozenBN", dtype=torch.float32,
                 device=None):
        super().__init__()
        self.names = sorted(in_channels)
        self.ida = IDAUp([in_channels[n] for n in self.names], out_channels, node_type, norm,
                         dtype, device)

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if sorted(features) != self.names:
            raise ValueError(f"features {sorted(features)} are not {self.names}")
        return {"dlaup": self.ida([features[n] for n in self.names]), **features}
