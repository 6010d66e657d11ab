"""Feature Pyramid Network with the P6/P7 top block (torch), NHWC.

Counterpart of ``divergen_tpu/modeling/backbone/fpn.py``: 1×1 lateral and 3×3
output convolutions, a top-down pathway with nearest-neighbour upsampling,
and ``top_block_levels`` extra stride-2 levels off the last output (P6 from
P5 as it is, P7 from ``relu(P6)``). Children carry the flax scope names
(``lateral_s3``, ``output_s3``, ``top_p6``, …).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvNorm


def _upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)


class FPN(nn.Module):
    """Builds p3..p7 from bottom-up features.

    in_features: bottom-up names ordered fine → coarse (s3, s4, s5) with
    their channel counts in ``in_channels``; out_channels: pyramid width;
    the first output level takes its number from the last character of
    ``in_features[0]`` (s3 → p3)."""

    def __init__(self, in_features: Sequence[str], in_channels: Sequence[int],
                 out_channels: int = 256, norm: str = "", top_block_levels: int = 2,
                 fuse_type: str = "sum", dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.fuse_type = tuple(in_features), fuse_type
        self.top_block_levels = top_block_levels
        for f, c in zip(in_features, in_channels):
            self.add_module(f"lateral_{f}", ConvNorm(c, out_channels, 1, 1, norm,
                                                     dtype=dtype, device=device))
            self.add_module(f"output_{f}", ConvNorm(out_channels, out_channels, 3, 1, norm,
                                                    dtype=dtype, device=device))
        tail = self.in_features[0][-1]
        self.base_level = int(tail) if tail.isdigit() else 3
        last = self.base_level + len(self.in_features) - 1
        for j in range(top_block_levels):
            self.add_module(f"top_p{last + j + 1}", ConvNorm(out_channels, out_channels, 3, 2, "",
                                                             dtype=dtype, device=device))

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [getattr(self, f"lateral_{f}")(bottom_up[f]) for f in self.in_features]
        results = [laterals[-1]]
        for lat in laterals[-2::-1]:
            top = _upsample_nearest_2x(results[0])
            merged = lat + top[:, :lat.shape[1], :lat.shape[2], :]  # crop to the lateral
            if self.fuse_type == "avg":
                merged = merged / 2.0
            results.insert(0, merged)
        outputs = [getattr(self, f"output_{f}")(x) for f, x in zip(self.in_features, results)]
        out = {f"p{self.base_level + i}": x for i, x in enumerate(outputs)}
        top_feat = outputs[-1]
        last = self.base_level + len(outputs) - 1
        for j in range(self.top_block_levels):
            name = f"p{last + j + 1}"
            top_feat = getattr(self, f"top_{name}")(F.relu(top_feat) if j > 0 else top_feat)
            out[name] = top_feat
        return out
