"""ConvNeXt backbone (torch), NHWC.

Counterpart of ``divergen_tpu/modeling/backbone/convnext.py``: a 4×4/4
patchify stem and LayerNorm, a LayerNorm + 2×2/2 conv downsample before each
later stage, and blocks of a 7×7 depthwise conv, LayerNorm (eps 1e-6, flax's
default), a 4× MLP with exact GELU and the layer scale ``gamma``. The stem and
the downsamples pad as flax's default ``"SAME"`` does (nothing where the
stride divides the extent, else the missing rows and columns at the end).
Emits ``c2..c5``, each through its own LayerNorm. Children carry the flax scope
names (``stem``, ``stem_norm``, ``down1_norm``, ``down1_conv``,
``stage2_block4.dwconv``, ``c3_norm``, …).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv, Dense, LayerNorm

SIZES = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
}
LN_EPS = 1e-6


class ConvNeXtBlock(nn.Module):
    """x + gamma · pwconv2(gelu(pwconv1(norm(dwconv(x)))))."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = LayerNorm(dim, eps=LN_EPS, device=device)
        self.pwconv1 = Dense(dim, 4 * dim, **kw)
        self.pwconv2 = Dense(4 * dim, dim, **kw)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + self.gamma.to(y.dtype) * y


class ConvNeXt(nn.Module):
    def __init__(self, depths: Tuple[int, ...] = (3, 3, 9, 3),
                 dims: Tuple[int, ...] = (96, 192, 384, 768),
                 out_features: Sequence[str] = ("c2", "c3", "c4", "c5"),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.depths, self.dtype = tuple(depths), dtype
        self.out_features = tuple(out_features)
        kw = dict(dtype=dtype, device=device)
        self.stem = Conv(3, dims[0], 4, stride=4, padding="SAME", **kw)
        self.stem_norm = LayerNorm(dims[0], eps=LN_EPS, device=device)
        for stage in range(4):
            if stage > 0:
                self.add_module(f"down{stage}_norm", LayerNorm(dims[stage - 1], eps=LN_EPS,
                                                               device=device))
                self.add_module(f"down{stage}_conv", Conv(dims[stage - 1], dims[stage], 2,
                                                          stride=2, padding="SAME", **kw))
            for i in range(depths[stage]):
                self.add_module(f"stage{stage}_block{i}", ConvNeXtBlock(dims[stage], **kw))
            if f"c{stage + 2}" in self.out_features:
                self.add_module(f"c{stage + 2}_norm", LayerNorm(dims[stage], eps=LN_EPS,
                                                                device=device))

    @classmethod
    def from_size(cls, size: str, dtype=torch.float32, **kw) -> "ConvNeXt":
        depths, dims = SIZES[size]
        return cls(depths=depths, dims=dims, dtype=dtype, **kw)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outs = {}
        x = self.stem_norm(self.stem(x.to(self.dtype)))
        for stage in range(4):
            if stage > 0:
                x = getattr(self, f"down{stage}_conv")(getattr(self, f"down{stage}_norm")(x))
            for i in range(self.depths[stage]):
                x = getattr(self, f"stage{stage}_block{i}")(x)
            name = f"c{stage + 2}"
            if name in self.out_features:
                outs[name] = getattr(self, f"{name}_norm")(x)
        return outs
