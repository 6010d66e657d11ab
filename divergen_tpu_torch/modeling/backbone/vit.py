"""ViTDet attention blocks (torch): windowed and global attention with
decomposed relative positions.

Counterpart of ``divergen_tpu/modeling/backbone/vit.py`` (``_rel_pos_bias``,
``ViTAttention``, ``window_partition``, ``window_unpartition``, ``ViTBlock``).
The SAM image encoder is built from these blocks. Submodules carry the flax
scope names (``norm1``, ``attn.qkv``, ``attn.proj``, ``mlp_fc1``, …).
The detection trunk: ``ViT`` (a 16×16/16 patch embedding, padded as flax's
default ``"SAME"``, plus a (64, 64, dim) position table sliced to the grid,
so canvases up to 1024²), ``SimpleFeaturePyramid`` (p2..p7 from the
stride-16 map) and ``ViTDet``. The global layers' relative-position tables
are sized by the grid of the canvas given at construction.

With ``ln_gemm`` the block's LayerNorms fold into the GEMMs that consume
them (``ops.ln_matmul.fused_ln_matmul``): norm2 → mlp_fc1 + exact GELU on
every layer, norm1 → qkv on global layers only, because window layers pad
zeros after norm1 and the norm cannot move past the padding. With
``flash_attn`` the global layers run ``ops.flash_attention.
flash_attention_relpos``: the (N, N) scores and bias never reach device
memory. Window layers (196 tokens) are dense products, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.flash_attention import flash_attention_relpos
from ...ops.ln_matmul import fused_ln_matmul
from ..layers import Conv, ConvTranspose, Dense, LayerNorm, max_pool

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


class ViT(nn.Module):
    """ViTDet trunk: (B, H, W, 3) → the stride-16 map (B, H/16, W/16, dim).
    ``input_hw`` is the canvas; it sizes the global layers' relative-position
    tables, and a forward at another grid raises."""

    raw_init_std = {"pos_embed": 0.02}

    def __init__(self, patch: int = 16, dim: int = 768, layers: int = 12, heads: int = 12,
                 window: int = 14, global_layers: Sequence[int] = (2, 5, 8, 11),
                 dtype=torch.float32, input_hw: Tuple[int, int] = (1024, 1024), device=None):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        self.grid = tuple(-(-n // patch) for n in input_hw)
        if max(self.grid) > 64:
            raise ValueError(f"canvas {tuple(input_hw)} exceeds the 64 × 64 position table "
                             f"({64 * patch} px a side)")
        self.patch_embed = Conv(3, dim, patch, stride=patch, padding="SAME", dtype=dtype,
                                device=device)
        self.pos_embed = nn.Parameter(torch.zeros(64, 64, dim, device=device))
        for i in range(layers):
            self.add_module(f"block{i}", ViTBlock(
                dim, heads, 0 if i in global_layers else window, dtype, input_hw=self.grid,
                device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.to(self.dtype))
        h, w = x.shape[1], x.shape[2]
        if (h, w) != self.grid:
            raise ValueError(f"ViT built for a {self.grid} grid (its global layers' "
                             f"relative-position tables) got a {(h, w)} grid; build it with "
                             f"input_size = the canvas")
        x = x + self.pos_embed[None, :h, :w].to(x.dtype)
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        return x


class SimpleFeaturePyramid(nn.Module):
    """ViTDet's pyramid: p2 and p3 by ×2 transposed convs (LayerNorm + GELU
    between the two of p2), p4 as it is, p5 by a 2×2 max-pool, each then
    1×1 conv → LayerNorm → 3×3 conv → LayerNorm; p6 and p7 take every
    other row and column of the level before."""

    def __init__(self, in_channels: int, out_channels: int = 256, dtype=torch.float32,
                 device=None):
        super().__init__()
        c = in_channels
        kw = dict(dtype=dtype, device=device)
        self.up4_1 = ConvTranspose(c, c // 2, 2, **kw)
        self.up4_ln = LayerNorm(c // 2, eps=LN_EPS, device=device)
        self.up4_2 = ConvTranspose(c // 2, c // 4, 2, **kw)
        self.up8 = ConvTranspose(c, c // 2, 2, **kw)
        for name, cin in (("p2", c // 4), ("p3", c // 2), ("p4", c), ("p5", c)):
            self.add_module(f"{name}_lateral", Conv(cin, out_channels, 1, bias=False, **kw))
            self.add_module(f"{name}_ln1", LayerNorm(out_channels, eps=LN_EPS, device=device))
            self.add_module(f"{name}_out", Conv(out_channels, out_channels, 3, padding=1,
                                                bias=False, **kw))
            self.add_module(f"{name}_ln2", LayerNorm(out_channels, eps=LN_EPS, device=device))

    def _norm_convs(self, y: torch.Tensor, name: str) -> torch.Tensor:
        y = getattr(self, f"{name}_ln1")(getattr(self, f"{name}_lateral")(y))
        return getattr(self, f"{name}_ln2")(getattr(self, f"{name}_out")(y))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        up4 = self.up4_2(F.gelu(self.up4_ln(self.up4_1(x))))
        outs = {"p2": self._norm_convs(up4, "p2"), "p3": self._norm_convs(self.up8(x), "p3"),
                "p4": self._norm_convs(x, "p4"), "p5": self._norm_convs(max_pool(x, 2, 2), "p5")}
        outs["p6"] = outs["p5"][:, ::2, ::2]  # flax max_pool (1, 1) at stride 2
        outs["p7"] = outs["p6"][:, ::2, ::2]
        return outs


class ViTDet(nn.Module):
    """``ViT`` + ``SimpleFeaturePyramid`` (scope ``sfp``): emits p2..p7 itself,
    so the detector builds no lateral FPN over it."""

    def __init__(self, vit: ViT, out_channels: int = 256, device=None):
        super().__init__()
        self.vit = vit
        self.sfp = SimpleFeaturePyramid(vit.patch_embed.out_channels, out_channels,
                                        dtype=vit.dtype, device=device)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.sfp(self.vit(x))
