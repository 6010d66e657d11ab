"""DINOv2 vision transformer (torch): the image tower of filtration's
``--method dinov2``.

Counterpart of ``divergen_tpu/modeling/backbone/dinov2.py``: a 14 × 14 / 14
patch embedding (padded as flax's default ``"SAME"``), a cls token and a
learned position table, ``depth`` pre-norm blocks with LayerScale on both
residual branches (``ls1``, ``ls2``), an exact-erf GELU MLP or, for the giant
model, a fused SwiGLU (``w12`` → silu(a) · b → ``w3``, hidden width 2/3 · 4 ·
dim rounded up to 8), and the final norm's cls token in float32. Children
carry the flax scope names (``patch_embed``, ``block{i}.attn.qkv``,
``block{i}.norm1``, ``norm``). The attention is plain torch, as the JAX
module's einsums are (no Pallas kernel serves it): float32 scores cast to
v's dtype after the softmax. Every LayerNorm has flax's eps 1e-6.

As in the JAX module, LayerScale's float32 vectors promote the residual
stream to float32 from the first block on whatever the compute dtype, and
the norms hand their output back in the compute dtype. The JAX module sizes
``pos_embed`` by the grid it sees at ``init`` and never interpolates; the
port sizes it at construction from ``image_size`` and raises on another grid.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv, Dense, LayerNorm

SIZES = {
    # dim, depth, heads, swiglu
    "vits14": (384, 12, 6, False),
    "vitb14": (768, 12, 12, False),
    "vitl14": (1024, 24, 16, False),
    "vitg14": (1536, 40, 24, True),
}
LN_EPS = 1e-6
PATCH = 14


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32, device=None):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(c // self.heads)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return self.proj((p @ v).transpose(1, 2).reshape(b, n, c))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, swiglu: bool, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.swiglu = dtype, swiglu
        self.ls1 = nn.Parameter(torch.full((dim,), 1e-5, device=device))
        self.ls2 = nn.Parameter(torch.full((dim,), 1e-5, device=device))
        self.norm1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = _Attention(dim, heads, **kw)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, device=device)
        if swiglu:
            hidden = (int(dim * 4 * 2 / 3) + 7) // 8 * 8
            self.w12 = Dense(dim, 2 * hidden, **kw)
            self.w3 = Dense(hidden, dim, **kw)
        else:
            self.fc1 = Dense(dim, 4 * dim, **kw)
            self.fc2 = Dense(4 * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1 * self.attn(self.norm1(x).to(self.dtype))
        y = self.norm2(x).to(self.dtype)
        if self.swiglu:
            a, b = self.w12(y).chunk(2, dim=-1)
            mlp = self.w3(F.silu(a) * b)
        else:
            mlp = self.fc2(F.gelu(self.fc1(y)))
        return x + self.ls2 * mlp


class DinoV2(nn.Module):
    """DINOv2 ViT for ``image_size`` × ``image_size`` inputs: ``forward``
    takes (B, H, W, 3) normalized images and returns the final norm's cls
    token (B, dim) in float32."""

    raw_init_std = {"cls_token": 0.02, "pos_embed": 0.02}

    def __init__(self, dim: int = 1536, depth: int = 40, heads: int = 24, swiglu: bool = True,
                 patch: int = PATCH, image_size: int = 224, dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.depth, self.dtype = dim, depth, dtype
        self.grid = -(-image_size // patch)  # flax "SAME" with stride = kernel
        self.patch_embed = Conv(3, dim, patch, stride=patch, padding="SAME", dtype=dtype,
                                device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid ** 2 + 1, dim, device=device))
        for i in range(depth):
            self.add_module(f"block{i}", _Block(dim, heads, swiglu, dtype=dtype, device=device))
        self.norm = LayerNorm(dim, eps=LN_EPS, device=device)

    @classmethod
    def from_name(cls, name: str = "vitg14", **kw) -> "DinoV2":
        dim, depth, heads, swiglu = SIZES[name.replace("dinov2_", "")]
        return cls(dim=dim, depth=depth, heads=heads, swiglu=swiglu, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        x = self.patch_embed(images.to(self.dtype))
        gh, gw = x.shape[1], x.shape[2]
        if (gh, gw) != (self.grid, self.grid):
            raise ValueError(f"a {gh} x {gw} patch grid; this DinoV2 was built for "
                             f"{self.grid} x {self.grid} (image_size), and its position "
                             "table is not interpolated")
        x = x.reshape(b, gh * gw, self.dim)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, self.dim), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x).to(self.dtype)[:, 0].float()


def dinov2_preprocess(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of 0..255 RGB (B, H, W, 3), in float32."""
    mean = torch.tensor([0.485, 0.456, 0.406], device=images.device) * 255.0
    std = torch.tensor([0.229, 0.224, 0.225], device=images.device) * 255.0
    return (images.float() - mean) / std
