"""ViTDet attention blocks (torch): windowed and global attention with
decomposed relative positions.

Counterpart of ``divergen_tpu/modeling/backbone/vit.py`` (``_rel_pos_bias``,
``ViTAttention``, ``window_partition``, ``window_unpartition``, ``ViTBlock``).
The SAM image encoder is built from these blocks. Submodules carry the flax
scope names (``norm1``, ``attn.qkv``, ``attn.proj``, ``mlp_fc1``, …). The
detection trunk (``ViT``, ``SimpleFeaturePyramid``, ``ViTDet``) comes with the
detector's slice.

With ``ln_gemm`` the block's LayerNorms fold into the GEMMs that consume
them (``ops.ln_matmul.fused_ln_matmul``): norm2 → mlp_fc1 + exact GELU on
every layer, norm1 → qkv on global layers only, because window layers pad
zeros after norm1 and the norm cannot move past the padding. With
``flash_attn`` the global layers run ``ops.flash_attention.
flash_attention_relpos``: the (N, N) scores and bias never reach device
memory. Window layers (196 tokens) are dense products, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.flash_attention import flash_attention_relpos
from ...ops.ln_matmul import fused_ln_matmul
from ..layers import Dense, LayerNorm

LN_EPS = 1e-6  # flax nn.LayerNorm's default, which every norm of the ViT uses


def _rel_pos_bias(q_hw: int, k_hw: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Decomposed 1D relative position table lookup, (q, k, C)."""
    coords_q = torch.arange(q_hw, device=rel_pos.device)[:, None]
    coords_k = torch.arange(k_hw, device=rel_pos.device)[None, :]
    return rel_pos[coords_q - coords_k + (k_hw - 1)]


class ViTAttention(nn.Module):
    """Multi-head attention over an (h, w) token grid, ``input_hw`` fixed at
    construction (it sizes the relative-position tables, which stay float32).

    The qkv projection's channels are [q | k | v], head-major inside each."""

    def __init__(self, dim: int, heads: int, use_rel_pos: bool = True,
                 input_hw: Tuple[int, int] = (14, 14), dtype=torch.float32,
                 flash_relpos: bool = False, device=None):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.use_rel_pos, self.flash_relpos = use_rel_pos, flash_relpos
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        if use_rel_pos:
            h, w = input_hw
            d = dim // heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * h - 1, d, device=device))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * w - 1, d, device=device))

    def forward(self, x: torch.Tensor, pre_ln: Optional[LayerNorm] = None) -> torch.Tensor:
        """x (B, H, W, C). With ``pre_ln`` x is the raw block input and that
        LayerNorm folds into the qkv GEMM."""
        b, h, w, c = x.shape
        heads, d = self.heads, self.dim // self.heads
        if pre_ln is not None:
            qkv = fused_ln_matmul(x.reshape(b * h * w, c).to(self.dtype), self.qkv.weight.t(),
                                  pre_ln.weight, pre_ln.bias, LN_EPS, self.qkv.bias)
        else:
            qkv = self.qkv(x)
        qkv = qkv.reshape(b, h * w, 3, heads, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, heads, d) views
        if self.use_rel_pos:
            rh = _rel_pos_bias(h, h, self.rel_pos_h)
            rw = _rel_pos_bias(w, w, self.rel_pos_w)
            qr = q.reshape(b, h, w, heads, d).float()  # the unscaled q
        if self.use_rel_pos and self.flash_relpos:
            # the (BH, u|v, N) bias factors are the only relative-position
            # tensors in device memory; the kernel reads q, k and v out of the
            # fused projection by stride and writes (B, N, C)
            bh_t = torch.einsum("byxhd,yud->bhuyx", qr, rh).reshape(b * heads, h, h * w)
            bw_t = torch.einsum("byxhd,xvd->bhvyx", qr, rw).reshape(b * heads, w, h * w)
            out = flash_attention_relpos(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                                         v.permute(0, 2, 1, 3), bh_t, bw_t, (h, w))
            return self.proj(out.permute(0, 2, 1, 3).reshape(b, h, w, c))
        attn = torch.einsum("bnhd,bmhd->bhnm", (q * d**-0.5).float(), k.float())
        if self.use_rel_pos:
            bias_h = torch.einsum("byxhd,yud->bhyxu", qr, rh)
            bias_w = torch.einsum("byxhd,xvd->bhyxv", qr, rw)
            bias = bias_h[..., :, None] + bias_w[..., None, :]
            attn = attn + bias.reshape(b, heads, h * w, h * w)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v.to(self.dtype))
        return self.proj(out.reshape(b, h, w, c))


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) → (B·windows, ws, ws, C), zero-padded to a multiple of ws."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, hw_pad: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = hw_pad
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class ViTBlock(nn.Module):
    """Pre-LN transformer block; ``window`` = 0 is global attention over the
    ``input_hw`` grid, else windows of ``window`` × ``window`` tokens."""

    def __init__(self, dim: int, heads: int, window: int = 0, dtype=torch.float32,
                 ln_gemm: bool = False, flash_attn: bool = False,
                 input_hw: Tuple[int, int] = (14, 14), device=None):
        super().__init__()
        self.dim, self.window, self.dtype, self.ln_gemm = dim, window, dtype, ln_gemm
        self.norm1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = ViTAttention(
            dim, heads, input_hw=(window, window) if window > 0 else input_hw, dtype=dtype,
            flash_relpos=flash_attn and window == 0, device=device)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp_fc1 = Dense(dim, 4 * dim, dtype=dtype, device=device)
        self.mlp_fc2 = Dense(4 * dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if self.window > 0:
            yw, hw_pad = window_partition(self.norm1(x), self.window)
            y = window_unpartition(self.attn(yw), self.window, hw_pad, (h, w))
        elif self.ln_gemm:
            y = self.attn(x, pre_ln=self.norm1)
        else:
            y = self.attn(self.norm1(x))
        x = x + y
        if self.ln_gemm:
            y = fused_ln_matmul(x.reshape(b * h * w, c).to(self.dtype), self.mlp_fc1.weight.t(),
                                self.norm2.weight, self.norm2.bias, LN_EPS, self.mlp_fc1.bias,
                                act="gelu").reshape(b, h, w, 4 * self.dim)
        else:
            y = F.gelu(self.mlp_fc1(self.norm2(x)))
        return x + self.mlp_fc2(y)
